"""DeepSeek-V2 on the port's serving path (models/llama.py's MLA and
DeepSeekMoE layers, ops/moe.py, the latent cache of models/generation.py,
YaRN in ops/rope.py, the loader in models/convert.py) against the plain
f32 reference (models/deepseek_v2_reference.py), at a tiny size on the
CPU: 3 layers (the first dense), hidden 128, 4 heads, latent 32 + rope 16,
nope 32, v 32, 8 experts, top 2, 1 shared.

Tolerance: both sides compute in f32 on the CPU from the same int8
weights (K1's plain version widens them exactly), so only the order of the
sums differs: 1e-4 on logits of order 1. Every planted fault moves them by
far more. The grouped kernels' card tests (marked `card`) run with
`python -m pytest tests/test_torch_deepseek_v2.py -m card` on the card.
"""

import dataclasses
import json
import math

import pytest
import torch

from revisionllm_tpu_torch.config import DeepseekV2Config, LlamaConfig
from revisionllm_tpu_torch.models import convert, generation, llama
from revisionllm_tpu_torch.models import deepseek_v2_reference as REF
from revisionllm_tpu_torch.ops import moe as MOE
from revisionllm_tpu_torch.ops import quant as Q
from revisionllm_tpu_torch.ops import rope as ROPE
from revisionllm_tpu_torch.utils import spans

TOL = 1e-4
CFG = dataclasses.replace(DeepseekV2Config.tiny(), dtype="float32")


@pytest.fixture(scope="module")
def params():
    return llama.init_params(CFG, seed=3, device="cpu", dtype=torch.float32, quantize=True)


def inputs(B=3, T=10, seed=1):
    g = torch.Generator().manual_seed(seed)
    emb = torch.randn(B, T, CFG.hidden_size, generator=g)
    lens = torch.tensor([T, T - 3, T - 1][:B], dtype=torch.int32)
    toks = torch.randint(0, CFG.vocab_size, (B, 4), generator=g)
    return emb, torch.arange(T)[None].expand(B, T), lens, toks


def served_gap(params, steps=3):
    """The widest gap between the served path's logits (prefill, then
    decode through the latent cache with teacher-forced tokens) and the
    reference's full forward over each row's prompt and tokens."""
    emb, pos, lens, toks = inputs()
    B = emb.shape[0]
    logits, cache = llama.prefill_kv(CFG, params, emb, pos, kv_lens=lens)
    got = [logits]
    gen = llama.init_gen_cache(CFG, B, steps + 1, torch.float32, "cpu")
    for step in range(steps):
        te = llama.embed_tokens(params, toks[:, step:step + 1])
        got.append(llama.decode_step_split(CFG, params, cache, lens, gen, step, te)[0])
    gap = 0.0
    for b in range(B):
        n = int(lens[b])
        seq = torch.cat([emb[b:b + 1, :n], llama.embed_tokens(params, toks[b:b + 1, :steps])], 1)
        ref = REF.forward_logits(CFG, params, seq, torch.arange(n + steps)[None])[0]
        for step in range(steps + 1):
            gap = max(gap, (got[step][b] - ref[n - 1 + step]).abs().max().item())
    return gap


def test_prefill_then_decode_matches_the_reference(params):
    assert served_gap(params) < TOL


def test_absorbed_decode_matches_the_decompressed_prefill(params):
    emb, pos, lens, toks = inputs(B=2, T=9)
    lens = torch.tensor([9, 9], dtype=torch.int32)
    logits, cache = llama.prefill_kv(CFG, params, emb, pos, kv_lens=lens)
    gen = llama.init_gen_cache(CFG, 2, 1, torch.float32, "cpu")
    te = llama.embed_tokens(params, toks[:, :1])
    absorbed = llama.decode_step_split(CFG, params, cache, lens, gen, 0, te)[0]
    longer = torch.cat([emb, te], 1)
    decompressed, full = llama.prefill_kv(CFG, params, longer, torch.arange(10)[None].expand(2, 10))
    assert (absorbed - decompressed).abs().max() < TOL
    # the step's latent is the one the longer prefill writes at that position
    assert torch.allclose(gen["latent"][:, :, 0], full["latent"][:, :, 9], atol=1e-5)


def test_generate_serves_the_references_greedy_tokens(params):
    emb, pos, lens, _ = inputs(B=2, T=8)
    lens = torch.tensor([8, 6], dtype=torch.int32)
    out = generation.generate(CFG, params, emb, pos, lens, eos_id=-1, max_new_tokens=4)
    for b in range(2):
        seq = emb[b:b + 1, : int(lens[b])]
        for g in range(4):
            ref = REF.forward_logits(CFG, params, seq, torch.arange(seq.shape[1])[None])[0, -1]
            assert int(out["tokens"][b, g]) == int(ref.argmax())
            seq = torch.cat([seq, llama.embed_tokens(params, out["tokens"][b:b + 1, g:g + 1])], 1)


def _yarn(dim, base, factor, orig, fast, slow):
    """YaRN's inverse frequencies from the paper's formulas (Peng et al.,
    2023, and modeling_deepseek.py), in float64."""
    def dim_of(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    lo, hi = max(math.floor(dim_of(fast)), 0), min(math.ceil(dim_of(slow)), dim - 1)
    out = []
    for i in range(dim // 2):
        extra = base ** (-2 * i / dim)
        ramp = min(max((i - lo) / (hi - lo), 0.0), 1.0)
        out.append(extra / factor * ramp + extra * (1 - ramp))
    return torch.tensor(out, dtype=torch.float64)


def test_yarn_frequencies_and_mscale():
    lite = LlamaConfig.deepseek_v2_lite()
    got = ROPE.yarn_inv_freq(64, 10000.0, 40.0, 4096, 32.0, 1.0)
    want = _yarn(64, 10000.0, 40.0, 4096, 32.0, 1.0)
    assert torch.allclose(got.double(), want, rtol=1e-6)
    assert torch.equal(got, REF.yarn_inv_freq(64, 10000.0, 40.0, 4096, 32.0, 1.0))
    m = 0.1 * 0.707 * math.log(40) + 1
    assert ROPE.yarn_mscale(40.0, 0.707) == pytest.approx(m)
    assert llama.mla_softmax_scale(lite) == pytest.approx(192 ** -0.5 * m * m)
    # mscale equals mscale_all_dim: the tables carry no factor
    cos, sin, inter = llama.mla_rope(lite, torch.arange(3)[None])
    assert inter and torch.allclose(cos[0, 0, 0], torch.ones(64))


def naive_routed(h, experts, w, idx, quantized):
    """The routed experts token by token, expert by expert, with the maths
    of the route taken: W8A8 (rows quantized, exact int32 products, f32
    scales, bf16 rounding between the matrices as the kernels store) or
    K1's plain one."""
    T, k = idx.shape
    Fm = experts["down"]["q8"].shape[1]
    out = torch.zeros(T, h.shape[-1])
    for t in range(T):
        for j in range(k):
            e = int(idx[t, j])
            if quantized:
                xq, xs = Q.quantize_rows_plain(h[t:t + 1])
                gu = Q.w8a8_gemm_plain(xq, xs, experts["gu"]["q8"][e], experts["gu"]["scale"][e])
                a = torch.nn.functional.silu(gu[:, :Fm]) * gu[:, Fm:]
                aq, as_ = Q.quantize_rows_plain(a)
                y = Q.w8a8_gemm_plain(aq, as_, experts["down"]["q8"][e],
                                      experts["down"]["scale"][e])
            else:
                gu = Q.int8_matmul_plain(h[t:t + 1], experts["gu"]["q8"][e],
                                         experts["gu"]["scale"][e])
                a = torch.nn.functional.silu(gu[:, :Fm]) * gu[:, Fm:]
                y = Q.int8_matmul_plain(a, experts["down"]["q8"][e], experts["down"]["scale"][e])
            out[t] += w[t, j] * y[0].float()
    return out.to(h.dtype)


@pytest.mark.parametrize("route", ["w8a16", "w8a8"])
def test_grouped_plain_versions_match_a_per_expert_loop(params, route):
    ex = llama.tree_at(params["moe"], 1)["experts"]
    T = 8 if route == "w8a16" else 1100   # above 256 rows an expert on average: W8A8
    g = torch.Generator().manual_seed(5)
    h = torch.randn(T, CFG.hidden_size, generator=g).to(torch.bfloat16)
    w, idx = MOE.route(h, params["moe"]["router"][1], CFG.num_experts_per_tok)
    Q.set_w8a8(route == "w8a8")
    try:
        got, counts = MOE.routed_experts(h, ex, w, idx)
    finally:
        Q.set_w8a8(None)
    want = naive_routed(h, ex, w, idx, route == "w8a8")
    assert torch.allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2)
    assert torch.equal(counts, torch.bincount(idx.reshape(-1), minlength=CFG.n_routed_experts))


def test_dispatch_layout():
    idx = torch.tensor([[3, 0], [3, 1], [0, 3], [5, 3]])
    d = MOE.dispatch(idx, 6, pad=4)
    assert d.counts.tolist() == [2, 1, 0, 4, 0, 1]
    assert d.starts.tolist() == [0, 4, 8, 8, 12, 12, 16]
    # each expert's rows in token order from its start
    assert d.dest.tolist() == [8, 0, 9, 4, 1, 10, 12, 11]
    assert d.capacity == 8 + 6 * 3 + 2 and d.capacity % 4 == 0
    assert d.tile_expert[:4].tolist() == [0, 1, 3, 5] and int(d.n_tiles) == 4
    d1 = MOE.dispatch(idx, 6)
    assert d1.starts.tolist() == [0, 2, 3, 3, 7, 7, 8] and d1.capacity == 8


def _skip_kv_a_norm(monkeypatch):
    real = llama.rms_norm

    def norm(x, w, eps=1e-5):
        return x if w.shape[-1] == CFG.kv_lora_rank else real(x, w, eps)

    monkeypatch.setattr(llama, "rms_norm", norm)


def _shift_an_offset(monkeypatch):
    real = MOE.dispatch

    def dispatch(idx, E, pad=1):
        d = real(idx, E, pad)
        starts = d.starts.clone()
        starts[int(d.counts.argmax())] += 1
        return d._replace(starts=starts)

    monkeypatch.setattr(MOE, "dispatch", dispatch)


FAULTS = {
    "kv_a_layernorm left out": _skip_kv_a_norm,
    "m squared left out": lambda mp: mp.setattr(llama, "mla_softmax_scale",
                                                lambda cfg: cfg.qk_head_dim ** -0.5),
    "an expert's offset shifted by one": _shift_an_offset,
    "shared experts dropped": lambda mp: mp.setattr(MOE, "swiglu",
                                                    lambda h, *a: torch.zeros_like(h)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_fail_the_comparison(params, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    assert served_gap(params) > 100 * TOL


@pytest.mark.parametrize("case", ["prefix", "training", "slab", "fused_mlp", "megakernel",
                                  "shared_prefix"])
def test_paths_out_of_scope_raise(params, case, monkeypatch):
    emb, pos, lens, _ = inputs(B=2, T=6)
    if case == "prefix":
        pk = torch.zeros(CFG.num_layers, 1, 2, 4, 32)
        call = lambda: llama.prefill_kv(CFG, params, emb, pos, kv_lens=lens,  # noqa: E731
                                        prefix_kv=(pk, pk))
    elif case == "training":
        call = lambda: llama.forward_hidden(CFG, params, emb, pos, trainable=True)  # noqa: E731
    elif case == "slab":
        call = lambda: llama.forward_hidden(CFG, params, emb, pos, kv_quant=True,  # noqa: E731
                                            kv_slab_slots=2)
    elif case == "fused_mlp":
        monkeypatch.setenv("REVISIONLLM_FUSED_MLP", "1")
        call = lambda: llama.prefill_kv(CFG, params, emb, pos, kv_lens=lens)  # noqa: E731
    elif case == "megakernel":
        monkeypatch.setenv("REVISIONLLM_MEGAKERNEL", "1")
        call = lambda: generation.generate(CFG, params, emb, pos, lens, eos_id=-1,  # noqa: E731
                                           max_new_tokens=2)
    else:
        call = lambda: llama.prefill_shared_prefix(CFG, params, emb, pos, 3)  # noqa: E731
    with pytest.raises(ValueError, match="DeepSeek-V2"):
        call()


def test_spans_and_counters(params):
    emb, pos, lens, _ = inputs(B=2, T=6)
    spans.reset()
    with spans.enabled():
        generation.generate(CFG, params, emb, pos, lens, eos_id=-1, max_new_tokens=2)
    recs = spans.records()
    spans.reset()
    names = [r["name"] for r in recs]
    # 3 layers of MLA and 2 MoE layers, in the prefill and the one decode step
    assert names.count("model.mla") == 6 and names.count("model.moe") == 4
    moe = [r for r in recs if r["name"] == "model.moe"]
    prefill = moe[0]["attrs"]
    assert prefill["rows"] == 12 and prefill["routed_rows"] == 24
    assert isinstance(prefill["max_expert_rows"], int) and 1 <= prefill["max_expert_rows"] <= 12
    assert 1 <= prefill["experts_hit"] <= CFG.n_routed_experts
    assert moe[-1]["attrs"]["rows"] == 2


def _hf_state(params):
    """The HF deepseek_v2 state dict of a dense port tree, written here
    independently of the loader ([out, in] matrices, HF's names)."""
    out = {"model.embed_tokens.weight": params["embed"], "model.norm.weight":
           params["final_norm"], "lm_head.weight": params["lm_head"].T}
    lay, k, Fm = params["layers"], CFG.first_k_dense_replace, CFG.moe_intermediate_size
    for i in range(CFG.num_layers):
        p = f"model.layers.{i}."
        for ours, theirs in (("q_proj", "q_proj"), ("kv_a_proj", "kv_a_proj_with_mqa"),
                             ("kv_b_proj", "kv_b_proj"), ("o_proj", "o_proj")):
            out[p + f"self_attn.{theirs}.weight"] = lay[ours][i].T
        out[p + "self_attn.kv_a_layernorm.weight"] = lay["kv_a_norm"][i]
        out[p + "input_layernorm.weight"] = lay["attn_norm"][i]
        out[p + "post_attention_layernorm.weight"] = lay["mlp_norm"][i]
        if i < k:
            for n in ("gate_proj", "up_proj", "down_proj"):
                out[p + f"mlp.{n}.weight"] = params["dense"][n][i].T
            continue
        m = params["moe"]
        out[p + "mlp.gate.weight"] = m["router"][i - k].T
        for e in range(CFG.n_routed_experts):
            gu = m["experts"]["gu"][i - k, e]
            out[p + f"mlp.experts.{e}.gate_proj.weight"] = gu[:, :Fm].T
            out[p + f"mlp.experts.{e}.up_proj.weight"] = gu[:, Fm:].T
            out[p + f"mlp.experts.{e}.down_proj.weight"] = m["experts"]["down"][i - k, e].T
        for n in ("gate", "up", "down"):
            out[p + f"mlp.shared_experts.{n}_proj.weight"] = m[f"shared_{n}"][i - k].T
    return {n: t.contiguous() for n, t in out.items()}


def test_loader_reads_a_deepseek_v2_checkpoint(tmp_path):
    dense = llama.init_params(CFG, seed=4, device="cpu", dtype=torch.float32)
    torch.save(_hf_state(dense), tmp_path / "pytorch_model.bin")
    hf = {"model_type": "deepseek_v2", "vocab_size": CFG.vocab_size, "hidden_size": 128,
          "intermediate_size": 256, "num_hidden_layers": 3, "num_attention_heads": 4,
          "num_key_value_heads": 4, "kv_lora_rank": 32, "q_lora_rank": None,
          "qk_nope_head_dim": 32, "qk_rope_head_dim": 16, "v_head_dim": 32,
          "n_routed_experts": 8, "n_shared_experts": 1, "num_experts_per_tok": 2,
          "moe_intermediate_size": 64, "first_k_dense_replace": 1, "moe_layer_freq": 1,
          "norm_topk_prob": False, "routed_scaling_factor": 1.0, "scoring_func": "softmax",
          "topk_method": "greedy", "rms_norm_eps": 1e-6, "rope_theta": 10000,
          "max_position_embeddings": 512,
          "rope_scaling": {"type": "yarn", "factor": 40, "original_max_position_embeddings": 64,
                           "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                           "mscale_all_dim": 0.707}}
    (tmp_path / "config.json").write_text(json.dumps(hf))
    cfg, got = convert.load_deepseek_v2(str(tmp_path), "cpu", dtype=torch.float32)
    assert dataclasses.replace(cfg, dtype="float32") == CFG
    want = llama.add_mla_layouts(CFG, Q_tree(dense))
    flat_g, flat_w = _flat(got), _flat(want)
    assert set(flat_g) == set(flat_w)
    for name, t in flat_w.items():
        assert flat_g[name].dtype == t.dtype and torch.equal(flat_g[name], t), name
    emb, pos, lens, _ = inputs(B=1, T=5)
    assert torch.allclose(REF.forward_logits(CFG, got, emb, pos),
                          REF.forward_logits(CFG, want, emb, pos))


def Q_tree(dense):
    """A dense tree's matrices int8 per output channel (the router f32,
    norms and embedding as they are)."""
    vectors = {"kv_a_norm", "attn_norm", "mlp_norm", "embed", "final_norm", "router"}

    def walk(node):
        out = {}
        for n, v in node.items():
            if isinstance(v, dict):
                out[n] = walk(v)
            elif n in vectors:
                out[n] = v
            else:
                q, s = Q.quantize_int8(v)
                out[n] = {"q8": q, "scale": s}
        return out

    return walk({k: v for k, v in dense.items()})


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _routing(T, k, E, case, dev):
    g = torch.Generator(device=dev).manual_seed(7)
    if case == "one":
        return torch.full((T, 1), 2, dtype=torch.long, device=dev)
    odds = torch.rand(E, generator=g, device=dev) ** 3 + 0.02
    odds[[1, 4]] = 0   # empty experts
    return torch.multinomial(odds.expand(T, E), k, replacement=False, generator=g)


@pytest.mark.card
@pytest.mark.parametrize("case", ["ragged", "one"])
def test_grouped_w8a8_kernel_on_the_card(cuda, case):
    E, K, N = 16, 256, 384
    idx = _routing(700, 4, E, case, cuda)
    d = MOE.dispatch(idx, E, MOE.W8A8_PAD)
    g = torch.Generator(device=cuda).manual_seed(8)
    xq, xs = Q.quantize_rows(torch.randn(d.capacity, K, generator=g, device=cuda)
                             .to(torch.bfloat16))
    wq, ws = Q.quantize_int8(torch.randn(E, K, N, generator=g, device=cuda))
    wt = wq.transpose(-1, -2).contiguous()
    used = torch.zeros(d.capacity, dtype=torch.bool, device=cuda)
    used[d.dest] = True
    got = MOE.grouped_w8a8(xq, xs, wt, ws, d)
    assert torch.equal(got[used], MOE.grouped_w8a8_plain(xq, xs, wt, ws, d)[used])


@pytest.mark.card
@pytest.mark.parametrize("case", ["ragged", "one"])
def test_grouped_w8a16_kernel_on_the_card(cuda, case):
    E, K, N, T = 16, 384, 256, 64
    idx = _routing(T, 4, E, case, cuda)
    d = MOE.dispatch(idx, E, 1)
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(idx.numel(), K, generator=g, device=cuda).to(torch.bfloat16)
    wq, ws = Q.quantize_int8(torch.randn(E, K, N, generator=g, device=cuda))
    got = MOE.grouped_w8a16(x, wq, ws, d, T).float()
    want = MOE.grouped_w8a16_plain(x, wq, ws, d).float()
    assert ((got - want).norm() / want.norm()).item() < 1e-2


@pytest.mark.card
def test_decode_graphs_replay_the_eager_steps(cuda):
    """On the card a shape's first chunk runs each MLA decode step eagerly
    and captures it, a CUDA graph a piece; later chunks replay: the same
    tokens and expert counts, entropies within bf16 noise. Replayed with
    spans recording, every layer of every step keeps its spans `model.mla`
    and `model.moe`, with the counters. At replay the wrappers count no
    launch: a replayed chunk counts its prefill's alone."""
    from revisionllm_tpu_torch.utils import kernels

    cfg = DeepseekV2Config.tiny()
    p = llama.init_params(cfg, seed=3, device=cuda, quantize=True)
    g = torch.Generator(device=cuda).manual_seed(2)
    emb = torch.randn(4, 40, cfg.hidden_size, generator=g, device=cuda).to(torch.bfloat16)
    lens = torch.tensor([40, 33, 38, 21], dtype=torch.int32, device=cuda)
    pos = torch.arange(40, device=cuda)[None].expand(4, 40)
    runs = []
    for spans_on in (False, False, True):
        kernels.reset_launches()
        spans.reset()
        with spans.enabled(spans_on):
            out = generation.generate(cfg, p, emb, pos, lens, eos_id=-1, max_new_tokens=5)
        torch.cuda.synchronize()
        counts = [[c.clone() for c in s] for s in generation.mla_decode_counts(p)]
        runs.append((out, dict(kernels.LAUNCHES), spans.records(), counts))
        spans.reset()
    first, want = runs[0][0], runs[0][3]
    assert len(want) == 4 and all(len(s) == 2 for s in want)
    for out, _, _, counts in runs[1:]:
        assert torch.equal(out["tokens"], first["tokens"])
        assert torch.allclose(out["entropy"], first["entropy"], atol=1e-3)
        assert all(torch.equal(a, b) for s, t in zip(counts, want) for a, b in zip(s, t))
    kernels.reset_launches()
    llama.prefill_kv(cfg, p, emb, pos, kv_lens=lens,
                     kv_quant=generation._kv8_enabled(emb.device))
    torch.cuda.synchronize()
    assert runs[1][1] == dict(kernels.LAUNCHES) != runs[0][1]
    recs = runs[2][2]
    names = [r["name"] for r in recs]
    assert names.count("model.mla") == 3 * 5 and names.count("model.moe") == 2 * 5
    decode = [r for r in recs if r["name"] == "model.moe"][2:]
    assert all(r["attrs"]["rows"] == 4 and 1 <= r["attrs"]["experts_hit"] <= 8
               and r["device_ms"] is not None for r in decode)
