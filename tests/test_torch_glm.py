"""Port parity: the ChatGLM2 geometry of models/llama.py against
revisionllm_tpu on the CPU, at tiny size in f32 (tolerance 1e-5 unless
stated): ChatGLM2's rotary (`apply_rope_interleaved`, half of each head in
(even, odd) pairs), the q/k/v biases (nonzero, drawn from the seed on both
sides: JAX's init leaves them at zero), `forward_hidden`, `prefill_kv` (bf16
and int8 caches), `decode_step_split`, the shared-prefix prefill, `generate`
over 32 query heads / 2 kv heads' shape class (4 over 2 here, and group 16
in K3's plain version), and `convert_chatglm` on a locally built ChatGLM2
state dict with a P-tuning prefix encoder."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revisionllm_tpu.config import LlamaConfig as JCfg
from revisionllm_tpu.models import convert as jconvert
from revisionllm_tpu.models import generation as jgen
from revisionllm_tpu.models import llama as jllama
from revisionllm_tpu.ops import quant as JQ
from revisionllm_tpu.ops import rope as jrope
from revisionllm_tpu_torch.config import LlamaConfig as TCfg
from revisionllm_tpu_torch.models import convert as tconvert
from revisionllm_tpu_torch.models import generation as tgen
from revisionllm_tpu_torch.models import llama as tllama
from revisionllm_tpu_torch.ops import decode_attention as TDA
from revisionllm_tpu_torch.ops import rope as trope

from torch_parity import np_of, to_torch

torch.set_num_threads(2)
TOL = 1e-5
GLM = dict(vocab_size=256, hidden_size=64, intermediate_size=96, num_layers=2, num_heads=4,
           num_kv_heads=2, head_dim=16, dtype="float32", rope_fraction=0.5,
           rope_interleaved=True, qkv_bias=True)
B, T = 3, 12
LENS = np.asarray([12, 9, 5], np.int32)


def glm_cfgs(**kw):
    return JCfg(**{**GLM, **kw}), TCfg(**{**GLM, **kw})


def glm_params(jcfg, seed=0, int8=False):
    """JAX's init with nonzero q/k/v biases and norms drawn from the seed;
    int8 by JAX's host quantizer, which leaves the biases dense (its device
    quantize_llama_params would quantize them as matrices)."""
    p = jllama.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    rng = np.random.default_rng(seed + 100)
    layers = dict(p["layers"])
    for name in ("q_bias", "k_bias", "v_bias"):
        layers[name] = jnp.asarray(0.3 * rng.normal(size=layers[name].shape), jnp.float32)
    for name in ("attn_norm", "mlp_norm"):
        layers[name] = layers[name] + jnp.asarray(0.1 * rng.normal(size=layers[name].shape),
                                                  jnp.float32)
    p = {**p, "layers": layers}
    if int8:
        p = jax.tree.map(jnp.asarray, JQ.quantize_llama_params_host(jax.tree.map(np.asarray, p)))
    return p


def _embeds(jcfg, seed=1, T=T, B=B):
    rng = np.random.default_rng(seed)
    embeds = (rng.normal(size=(B, T, jcfg.hidden_size)) * 0.5).astype(np.float32)
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    return embeds, positions


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=tol, atol=tol)


def _int8_close(got, want):
    """An int8 cache may round across a .5 boundary on one side only."""
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 5e-3


# ------------------------------------------------------------------- rope


@pytest.mark.parametrize("hd,rot", [(16, 8), (16, 16), (128, 64)])
def test_apply_rope_interleaved_matches_jax(hd, rot):
    rng = np.random.default_rng(hd + rot)
    x = rng.normal(size=(2, 7, 3, hd)).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 5, 30, 300, 4000]] * 2, np.int32)
    jc, js = jrope.rope_angles(jnp.asarray(pos), rot)
    tc, ts = trope.rope_angles(torch.from_numpy(pos), rot)
    want = np.asarray(jrope.apply_rope_interleaved(jnp.asarray(x), jc, js, rot))
    got = trope.apply_rope_interleaved(torch.from_numpy(x), tc, ts, rot).numpy()
    # angles up to 4000 rad: f32 cos/sin differ by an ulp or two
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got[..., rot:], x[..., rot:])


def test_rope_tables_leave_vicuna_unchanged():
    """rope_for on a Vicuna geometry is the half-split rotation."""
    cfg = TCfg.tiny()
    pos = torch.arange(6)[None]
    x = torch.randn(1, 6, 2, cfg.head_dim)
    c, s = trope.rope_angles(pos, cfg.head_dim)
    torch.testing.assert_close(trope.apply_rope_tables(x, *tllama.rope_for(cfg, pos)),
                               trope.apply_rope(x, c, s), rtol=0, atol=0)


# --------------------------------------------------------------- backbone


def test_init_params_has_zero_biases_like_jax():
    jcfg, tcfg = glm_cfgs()
    want = jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)["layers"]
    got = tllama.init_params(tcfg, seed=0, dtype=torch.float32, device="cpu")["layers"]
    assert set(got) == set(want)
    for name in ("q_bias", "k_bias", "v_bias"):
        assert tuple(got[name].shape) == want[name].shape and not got[name].any()


@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
def test_forward_hidden_matches_jax(int8):
    jcfg, tcfg = glm_cfgs()
    jp = glm_params(jcfg, int8=int8)
    embeds, positions = _embeds(jcfg)
    want = jllama.forward_hidden(jcfg, jp, jnp.asarray(embeds), jnp.asarray(positions),
                                 kv_lens=jnp.asarray(LENS))
    got = tllama.forward_hidden(tcfg, to_torch(jp), torch.from_numpy(embeds),
                                torch.from_numpy(positions), kv_lens=torch.from_numpy(LENS))
    _close(got, want, 1e-4 if int8 else TOL)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["kv16", "kv8"])
def test_prefill_kv_and_decode_step_split_match_jax(kv_quant):
    """prefill_kv's logits and cache, then three decode_step_split steps
    (K3's plain version at group 2) on the same cache: logits within 1e-4."""
    jcfg, tcfg = glm_cfgs()
    jp = glm_params(jcfg, seed=2)
    tp = to_torch(jp)
    embeds, positions = _embeds(jcfg, seed=3)
    jl, jc = jllama.prefill_kv(jcfg, jp, jnp.asarray(embeds), jnp.asarray(positions),
                               kv_lens=jnp.asarray(LENS), kv_quant=kv_quant)
    tl, tc = tllama.prefill_kv(tcfg, tp, torch.from_numpy(embeds), torch.from_numpy(positions),
                               kv_lens=torch.from_numpy(LENS), kv_quant=kv_quant)
    _close(tl, jl, 1e-4)
    assert set(tc) == set(jc)
    for name in jc:
        if tc[name].dtype == torch.int8:
            _int8_close(tc[name].numpy(), jc[name])
        else:
            _close(tc[name], jc[name], 1e-4)
    # decode over JAX's cache on both sides
    tc = to_torch(jc)
    G = 4
    jg = {n: jnp.zeros((2, B, G, 2, 16), jnp.float32) for n in ("k", "v")}
    tg = tllama.init_gen_cache(tcfg, B, G, torch.float32, "cpu")
    rng = np.random.default_rng(4)
    for step in range(3):
        tok = rng.normal(size=(B, 1, jcfg.hidden_size)).astype(np.float32)
        jlog, jg = jllama.decode_step_split(jcfg, jp, jc, jnp.asarray(LENS), jg,
                                            jnp.asarray(step, jnp.int32), jnp.asarray(tok))
        tlog, tg = tllama.decode_step_split(tcfg, tp, tc, torch.from_numpy(LENS), tg, step,
                                            torch.from_numpy(tok))
        _close(tlog, jlog, 1e-4)
        _close(tg["k"], jg["k"], 1e-4)


def test_prefill_shared_prefix_matches_jax():
    jcfg, tcfg = glm_cfgs()
    jp = glm_params(jcfg, seed=5)
    embeds, positions = _embeds(jcfg, seed=6)
    embeds[1:, :4] = embeds[0, :4]
    jl, jc = jllama.prefill_shared_prefix(jcfg, jp, jnp.asarray(embeds), jnp.asarray(positions),
                                          4, kv_lens=jnp.asarray(LENS))
    tl, tc = tllama.prefill_shared_prefix(tcfg, to_torch(jp), torch.from_numpy(embeds),
                                          torch.from_numpy(positions), 4,
                                          kv_lens=torch.from_numpy(LENS))
    _close(tl, jl, 1e-4)
    for name in ("k", "v"):
        _close(tc[name], jc[name], 1e-4)


@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
def test_generate_matches_jax(int8):
    """Greedy tokens equal, entropies within 1e-4."""
    jcfg, tcfg = glm_cfgs()
    jp = glm_params(jcfg, seed=7, int8=int8)
    embeds, positions = _embeds(jcfg, seed=8)
    kw = dict(eos_id=2, max_new_tokens=5)
    want = jgen.generate(jcfg, jp, jnp.asarray(embeds), jnp.asarray(positions),
                         jnp.asarray(LENS), **kw)
    got = tgen.generate(tcfg, to_torch(jp), torch.from_numpy(embeds),
                        torch.from_numpy(positions), torch.from_numpy(LENS), **kw)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    _close(got["entropy"], want["entropy"], 1e-4)


def test_decode_attention_plain_at_group_16():
    """K3's plain version at ChatGLM2-6B's group (32 query heads over 2 kv
    heads; an int8 prompt cache with its scales) against the einsums of
    JAX's decode_step_split (llama.py:686-749) in f32."""
    rng = np.random.default_rng(16)
    Bq, KH, group, hd, S, G, step = 2, 2, 16, 32, 20, 5, 3
    q = rng.normal(size=(Bq, KH, group, hd)).astype(np.float32)
    pk, pv = (rng.integers(-127, 128, (Bq, S, KH, hd)).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.005, 0.025, (Bq, S, KH)).astype(np.float32) for _ in range(2))
    gk, gv = (rng.normal(size=(Bq, G, KH, hd)).astype(np.float32) for _ in range(2))
    lens = np.asarray([20, 11], np.int32)
    t = torch.from_numpy
    got = TDA.decode_attention_plain(t(q), t(pk), t(pv), t(ks), t(vs), t(gk), t(gv), t(lens),
                                     step)
    scale = hd ** -0.5
    s1 = np.einsum("bkgd,bskd->bkgs", q, pk.astype(np.float32)) * scale
    s1 = s1 * ks.transpose(0, 2, 1)[:, :, None, :]
    s1 = np.where(np.arange(S)[None, None, None] < lens[:, None, None, None], s1, -2e30)
    s2 = np.einsum("bkgd,bskd->bkgs", q, gk) * scale
    s2 = np.where(np.arange(G) <= step, s2, -2e30)
    m = np.maximum(s1.max(-1, keepdims=True), s2.max(-1, keepdims=True))
    p1, p2 = np.exp(s1 - m), np.exp(s2 - m)
    den = p1.sum(-1, keepdims=True) + p2.sum(-1, keepdims=True)
    o = (np.einsum("bkgs,bskd->bkgd", p1 * vs.transpose(0, 2, 1)[:, :, None, :],
                   pv.astype(np.float32)) + np.einsum("bkgs,bskd->bkgd", p2, gv)) / den
    np.testing.assert_allclose(got.numpy(), o, rtol=1e-4, atol=1e-5)
    assert 16 in TDA.K3_GROUPS


# ------------------------------------------------------------- conversion


def glm_state(cfg, rng, prefix=None):
    """A ChatGLM2 state dict at cfg's geometry (packed qkv and h_to_4h),
    with a prefix encoder: None, "embed" or "proj" (the table and the
    2-layer projection)."""
    L, D, ffn = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    q_out, kv_out = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def n(*shape):
        return rng.normal(size=shape).astype(np.float32)

    state = {"transformer.embedding.word_embeddings.weight": n(cfg.vocab_size, D),
             "transformer.encoder.final_layernorm.weight": n(D),
             "transformer.output_layer.weight": n(cfg.vocab_size, D)}
    for i in range(L):
        pre = f"transformer.encoder.layers.{i}"
        state[f"{pre}.self_attention.query_key_value.weight"] = n(q_out + 2 * kv_out, D)
        state[f"{pre}.self_attention.query_key_value.bias"] = n(q_out + 2 * kv_out)
        state[f"{pre}.self_attention.dense.weight"] = n(D, q_out)
        state[f"{pre}.mlp.dense_h_to_4h.weight"] = n(2 * ffn, D)
        state[f"{pre}.mlp.dense_4h_to_h.weight"] = n(D, ffn)
        state[f"{pre}.input_layernorm.weight"] = n(D)
        state[f"{pre}.post_attention_layernorm.weight"] = n(D)
    if prefix:
        kv_size = L * 2 * cfg.num_kv_heads * cfg.head_dim
        pe = "transformer.prefix_encoder."
        state[pe + "embedding.weight"] = n(5, kv_size)
        if prefix == "proj":
            state.update({pe + "trans.0.weight": n(D, kv_size), pe + "trans.0.bias": n(D),
                          pe + "trans.2.weight": n(kv_size, D), pe + "trans.2.bias": n(kv_size)})
    return state


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree) for p, v in _flat(tree[k], f"{path}/{k}").items()}
    return {path: tree}


@pytest.mark.parametrize("prefix", [None, "embed", "proj"])
def test_convert_chatglm_matches_jax(prefix):
    """The converted tree equals JAX's leaf for leaf (names, shapes, values);
    the port's serves the same first logits as JAX's tree."""
    jcfg, tcfg = glm_cfgs()
    state = glm_state(jcfg, np.random.default_rng(0), prefix)
    want = _flat(jconvert.convert_chatglm(state, jcfg))
    got = _flat(tconvert.convert_chatglm(state, tcfg))
    assert set(got) == set(want) and ("/prefix/embed" in got) == bool(prefix)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    tree = tconvert.convert_chatglm(state, tcfg)
    tree.pop("prefix", None)
    ids = torch.arange(8)[None]
    h = tllama.forward_hidden(tcfg, to_torch(tree), tllama.embed_tokens(to_torch(tree), ids),
                              ids)
    assert torch.isfinite(h).all()
