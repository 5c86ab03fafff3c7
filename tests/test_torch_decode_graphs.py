"""The split decode steps replayed as CUDA graphs (models/generation.py
`DecodeGraphs`). On the CPU: the invariant the graphs' static buffers rest
on (a prompt cache padded past each row's length with garbage gives the
unpadded step's logits), the prefill writing its cache into a set's
buffers (`kv_out`), that the CPU builds no graph set, and the bound on the
sets a tree keeps. On the card (`-m card`): GLM-shaped (group 16,
q/k/v biases, half interleaved rotary) and Vicuna-shaped (group 1) int8
trees through three `generate` calls, a first chunk (eager, then capture),
a second of another length in the same bucket (replay over stale padding)
and a third in another bucket (a new set), held against the unpadded eager
split steps."""

import re

import pytest
import torch

from revisionllm_tpu_torch.config import LlamaConfig
from revisionllm_tpu_torch.models import generation, llama
from revisionllm_tpu_torch.utils import kernels, spans

torch.set_num_threads(2)

SHAPES = {
    # ChatGLM2's class: 2 kv heads, group 2 here (16 on the card), biases,
    # rotary over half of each head in interleaved pairs
    "glm": dict(num_heads=4, num_kv_heads=2, qkv_bias=True, rope_interleaved=True,
                rope_fraction=0.5),
    # Vicuna's and DeepSeek-LLM's class: group 1, rotary over the whole head
    "vicuna": dict(num_heads=4, num_kv_heads=4),
}
# the card's: head_dim 128 (K3's), ChatGLM2's 32 query heads over 2 kv heads
CARD_SHAPES = {
    "glm": dict(num_heads=32, num_kv_heads=2, qkv_bias=True, rope_interleaved=True,
                rope_fraction=0.5),
    "vicuna": dict(num_heads=4, num_kv_heads=4),
}


def _config(shape, dtype, head_dim=16, hidden=64, **extra):
    return LlamaConfig(vocab_size=256, hidden_size=hidden, intermediate_size=2 * hidden,
                       num_layers=2, head_dim=head_dim, dtype=dtype,
                       **{**shape, **extra})


def _params(cfg, device, seed=0):
    """An int8 tree with nonzero q/k/v biases (init_params leaves them 0)."""
    p = llama.init_params(cfg, seed=seed, device=device, quantize=True)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    for name in ("q_bias", "k_bias", "v_bias"):
        if name in p["layers"]:
            b = p["layers"][name]
            p["layers"][name] = (0.3 * torch.randn(b.shape, generator=g, device=device)).to(b.dtype)
    return p


def _padded(prompt_kv, lens, S, seed):
    """The prompt cache grown to S positions, every position past each row's
    length replaced by garbage: random int8 values and scales, or random
    values in the cache's type."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in prompt_kv.items():
        shape = (t.shape[0], t.shape[1], S) + tuple(t.shape[3:])
        if t.dtype == torch.int8:
            junk = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
        else:
            junk = (torch.rand(shape, generator=g) * 3.0 + 0.01).to(t.dtype)
        for b, n in enumerate(lens.tolist()):
            junk[:, b, :n] = t[:, b, :n]
        out[name] = junk
    return out


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("cache", ["int8", "bf16"])
def test_padded_prompt_cache_gives_the_unpadded_step(shape, cache):
    """decode_step_split over the prompt cache padded to the graphs' bucket,
    garbage past each row's length, gives the unpadded step's logits within
    1e-5 at every step (the plain path: the garbage is masked, and adds
    exact zeros)."""
    cfg = _config(SHAPES[shape], "bfloat16" if cache == "bf16" else "float32")
    dt = llama.torch_dtype(cfg.dtype)
    p = _params(cfg, "cpu")
    B, T, steps = 3, 21, 4
    g = torch.Generator().manual_seed(5)
    emb = (torch.randn(B, T, cfg.hidden_size, generator=g) * 0.5).to(dt)
    pos = torch.arange(T)[None].expand(B, T)
    lens = torch.tensor([21, 14, 9], dtype=torch.int32)
    _, pkv = llama.prefill_kv(cfg, p, emb, pos, kv_lens=lens, kv_quant=cache == "int8")
    S = -(-T // generation.DECODE_GRAPH_POSITIONS) * generation.DECODE_GRAPH_POSITIONS
    wide = _padded(pkv, lens, S, seed=7)
    assert set(wide) == set(pkv) and wide["k"].shape[2] == S > T
    gen_a = llama.init_gen_cache(cfg, B, steps, dt, "cpu")
    gen_b = llama.init_gen_cache(cfg, B, steps, dt, "cpu")
    for step in range(steps):
        tok = (torch.randn(B, 1, cfg.hidden_size, generator=g) * 0.5).to(dt)
        want = llama.decode_step_split(cfg, p, pkv, lens, gen_a, step, tok)[0]
        got = llama.decode_step_split(cfg, p, wide, lens, gen_b, step, tok)[0]
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("prefill", ["plain", "shared prefix", "ptuning", "mla"])
@pytest.mark.parametrize("cache", ["int8", "bf16"])
def test_prefill_writes_its_cache_into_kv_out(prefill, cache):
    """With kv_out (a graph set's buffers, prompt_cache_layout over more
    positions) the prefill returns the views of kv_out's first T positions
    (P + T with a P-tuning prefix, held at [0, P)), holding the cache it
    returns without kv_out, the logits unchanged and the positions past
    them as they were."""
    from revisionllm_tpu_torch.config import DeepseekV2Config

    kv8 = cache == "int8"
    cfg = (DeepseekV2Config.tiny() if prefill == "mla"
           else _config(SHAPES["glm"], "bfloat16" if cache == "bf16" else "float32"))
    dt = llama.torch_dtype(cfg.dtype)
    p = _params(cfg, "cpu")
    B, T, S = 3, 21, 64
    g = torch.Generator().manual_seed(4)
    emb = (torch.randn(B, T, cfg.hidden_size, generator=g) * 0.5).to(dt)
    emb[:, :6] = emb[:1, :6]
    pos = torch.arange(T)[None].expand(B, T)
    lens = torch.tensor([21, 14, 9], dtype=torch.int32)
    P, prefix = 0, None
    if prefill == "ptuning":  # an f32 prefix, as models.prefix makes it
        P = 5
        prefix = tuple(torch.randn(cfg.num_layers, 1, P, cfg.num_kv_heads, cfg.head_dim,
                                   generator=g) for _ in range(2))
    layout = llama.prompt_cache_layout(cfg, B, S, kv8, dt)
    kv_out = {n: torch.full(shape, 7, dtype=d) for n, (shape, d) in layout.items()}

    def run(out):
        if prefill == "shared prefix":
            return llama.prefill_shared_prefix(cfg, p, emb, pos, 6, kv_lens=lens, kv_quant=kv8,
                                               kv_out=out)
        return llama.prefill_kv(cfg, p, emb, pos, kv_lens=lens, kv_quant=kv8, prefix_kv=prefix,
                                kv_out=out)

    want_logits, want = run(None)
    logits, got = run(kv_out)
    assert set(got) == set(want) == set(kv_out)
    assert torch.equal(logits, want_logits)
    for name, t in got.items():
        assert t.data_ptr() == kv_out[name].data_ptr() and t.dtype == want[name].dtype
        assert t.shape[2] == want[name].shape[2] == P + T
        assert torch.equal(t, want[name])
        assert (kv_out[name][:, :, P + T:] == 7).all()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_generate_on_the_cpu_builds_no_graph_set(shape):
    cfg = _config(SHAPES[shape], "float32")
    p = _params(cfg, "cpu")
    emb = torch.randn(2, 10, cfg.hidden_size) * 0.5
    pos = torch.arange(10)[None].expand(2, 10)
    with spans.enabled():
        out = generation.generate(cfg, p, emb, pos, torch.tensor([10, 7]), eos_id=-1,
                                  max_new_tokens=4)
    recs = spans.records()
    spans.reset()
    assert out["tokens"].shape == (2, 4)
    assert p["embed"] not in generation._DECODE_GRAPHS
    assert generation.mla_decode_counts(p) == []
    steps = [r for r in recs if r["name"] == "model.decode_step"]
    assert [r["attrs"] for r in steps] == [{"step": s, "replayed": 0} for s in range(3)]


def test_a_tree_keeps_at_most_its_bound_of_graph_sets():
    """_graph_set keeps DECODE_GRAPH_SETS shapes a tree, the most recently
    used last; a shape used again moves to the end and is not made again;
    a new one drops the least recently used first. Trees do not share."""
    n = generation.DECODE_GRAPH_SETS
    p, q = {"embed": torch.zeros(4, 2)}, {"embed": torch.zeros(4, 2)}
    made = []

    def maker(key):
        return lambda: made.append(key) or f"set {key}"

    for key in range(n + 1):
        assert generation._graph_set(p, key, maker(key)) == f"set {key}"
    assert list(generation._DECODE_GRAPHS[p["embed"]]) == list(range(1, n + 1))
    assert generation._graph_set(p, 1, maker("again")) == "set 1"
    assert "again" not in made
    generation._graph_set(p, n + 1, maker(n + 1))
    sets = generation._DECODE_GRAPHS[p["embed"]]
    assert len(sets) == n and list(sets)[-2:] == [1, n + 1]
    generation._graph_set(q, 0, maker("q"))
    assert list(generation._DECODE_GRAPHS[q["embed"]]) == [0] and len(sets) == n
    assert made == list(range(n + 2)) + ["q"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _eager(cfg, p, emb, pos, lens, G):
    """generate's greedy loop (no eos) over the unpadded prompt cache, every
    step llama.decode_step_split run eagerly: tokens, entropy, logprob."""
    B = emb.shape[0]
    logits, pkv = llama.prefill_kv(cfg, p, emb, pos, kv_lens=lens, kv_quant=True)
    gen = llama.init_gen_cache(cfg, B, G, emb.dtype, emb.device)
    toks, ents, lps = [], [], []
    for g in range(G):
        probs = torch.softmax(logits.float(), dim=-1)
        tok = torch.argmax(probs, dim=-1)
        toks.append(tok)
        ents.append(-(probs * torch.log(probs + 1e-10)).sum(dim=-1))
        lps.append(torch.log(probs.gather(-1, tok[:, None])[:, 0] + 1e-10))
        if g + 1 < G:
            e = llama.embed_tokens(p, tok[:, None]).to(emb.dtype)
            logits = llama.decode_step_split(cfg, p, pkv, lens, gen, g, e)[0]
    return torch.stack(toks, 1), torch.stack(ents, 1), torch.stack(lps, 1)


@pytest.mark.card
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_dense_decode_graphs_replay_the_eager_steps(cuda, shape):
    """Three chunks on one int8 tree: 40 positions (a new set: each step
    eager, then captured), 50 (the same 64-position bucket: replayed over
    the first chunk's stale padding) and 70 (another bucket: a new set).
    Each gives the unpadded eager split steps' tokens, entropies and
    logprobs within 1e-3. Each step is one `model.decode_step` (spans on),
    `replayed` 0 in a new set; replayed, each has a device interval and
    `replayed` 1, the wrappers count the prefill's launches alone and the
    profiler sees K3's launches in every step."""
    cfg = _config(CARD_SHAPES[shape], "bfloat16", head_dim=128, hidden=256)
    p = _params(cfg, cuda, seed=3)
    B, G = 4, 6
    g = torch.Generator(device=cuda).manual_seed(2)
    runs = {}
    for label, T, lens in (("first", 40, [40, 33, 38, 21]), ("same bucket", 50, [50, 12, 47, 30]),
                           ("new bucket", 70, [70, 65, 41, 69])):
        emb = (torch.randn(B, T, cfg.hidden_size, generator=g, device=cuda) * 0.5) \
            .to(torch.bfloat16)
        pos = torch.arange(T, device=cuda)[None].expand(B, T)
        lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
        kernels.reset_launches()
        spans.reset()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof, \
                spans.enabled():
            out = generation.generate(cfg, p, emb, pos, lens, eos_id=-1, max_new_tokens=G)
            torch.cuda.synchronize()
        k3 = sum(re.search(r"(?<!\w)decode_attn_kernel", e.name) is not None
                 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        recs = spans.records()
        spans.reset()
        launches = dict(kernels.LAUNCHES)
        kernels.reset_launches()
        llama.prefill_kv(cfg, p, emb, pos, kv_lens=lens, kv_quant=True)
        torch.cuda.synchronize()
        prefill_only = dict(kernels.LAUNCHES)
        toks, ent, lp = _eager(cfg, p, emb, pos, lens, G)
        assert torch.equal(out["tokens"], toks), label
        assert out["valid"].all()
        assert torch.allclose(out["entropy"], ent, atol=1e-3), label
        assert torch.allclose(out["logprob"], lp, atol=1e-3), label
        steps = [r for r in recs if r["name"] == "model.decode_step"]
        runs[label] = (launches, prefill_only, steps, k3)
    L = cfg.num_layers
    for label, replayed in (("first", 0), ("same bucket", 1), ("new bucket", 0)):
        launches, prefill_only, steps, k3 = runs[label]
        assert [r["attrs"] for r in steps] == [{"step": s, "replayed": replayed}
                                               for s in range(G - 1)], label
        assert k3 == L * (G - 1), label
        if replayed:
            assert launches == prefill_only
            assert all(r["device_ms"] is not None and r["device_ms"] > 0 for r in steps)
        else:
            assert launches["decode_attention"] == 2 * L * (G - 1), label
    sets = generation._DECODE_GRAPHS[p["embed"]]
    assert [graphs.prompt["k"].shape[2] for graphs in sets.values()] == [64, 128]
