"""Port parity for the shared-prefix prefill: ops/flash_attention.py rows 5
(flash_attention_lse) and 6 (flash_attention_prefixed) with their plain
versions, mha_reference_lse, merge_attention_pieces and attention_lse, then
models/llama.py prefill_shared_prefix and generation.generate with
shared_prefix_len, against revisionllm_tpu on the CPU (f32; the Pallas
kernels in interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revisionllm_tpu.models import generation as jgen
from revisionllm_tpu.models import llama as jllama
from revisionllm_tpu.ops import flash_attention as JFA
from revisionllm_tpu.ops import quant as JQ
from revisionllm_tpu_torch.models import generation as tgen
from revisionllm_tpu_torch.models import llama as tllama
from revisionllm_tpu_torch.ops import flash_attention as TFA
from revisionllm_tpu_torch.utils import kernels

from torch_parity import np_of, tiny_cfgs, to_torch

torch.set_num_threads(2)

LSE_CASES = {
    # name: (B, T, S, H, KH, d, causal, kv_lens); every row sees a key
    "causal_ragged": (2, 40, 40, 4, 4, 32, True, [40, 23]),
    "causal_t_lt_s_gqa": (2, 24, 56, 4, 2, 32, True, [56, 9]),
    "noncausal_t_gt_s": (2, 40, 24, 2, 2, 32, False, [24, 5]),
    "noncausal_gqa_full": (1, 37, 45, 4, 1, 32, False, None),
}
PREFIX_CASES = {
    # name: (B, T, P, H, KH, d, rest_lens); P is no multiple of the blocks
    "ragged": (3, 40, 37, 4, 4, 32, [40, 17, 1]),
    "gqa_full": (2, 33, 16, 4, 2, 32, None),
    "short_prefix": (2, 24, 5, 2, 1, 32, [24, 24]),
}


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _lse_inputs(case, seed=0):
    B, T, S, H, KH, d, causal, lens = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, d)).astype(np.float32)
    k = rng.normal(size=(B, S, KH, d)).astype(np.float32)
    v = rng.normal(size=(B, S, KH, d)).astype(np.float32)
    return q, k, v, None if lens is None else np.asarray(lens, np.int32), causal


def _prefix_inputs(case, seed=0):
    B, T, P, H, KH, d, lens = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, d)).astype(np.float32)
    k, v = (rng.normal(size=(B, T, KH, d)).astype(np.float32) for _ in range(2))
    pk, pv = (rng.normal(size=(1, P, KH, d)).astype(np.float32) for _ in range(2))
    return q, k, v, pk, pv, None if lens is None else np.asarray(lens, np.int32)


@pytest.mark.parametrize("name", sorted(LSE_CASES))
def test_flash_attention_lse_matches_pallas_interpret(name):
    """Row 5's plain version (the CPU branch of flash_attention_lse) against
    JAX's Pallas kernel in interpret mode (16-row blocks): o and the
    [B, T, H] lse within 1e-5 in f32."""
    q, k, v, lens, causal = _lse_inputs(LSE_CASES[name])
    jo, jl = JFA.flash_attention_lse(*_j(q, k, v), causal=causal,
                                     kv_lens=None if lens is None else jnp.asarray(lens),
                                     block_q=16, block_k=16, interpret=True)
    to, tl = TFA.flash_attention_lse(*_t(q, k, v), causal=causal,
                                     kv_lens=None if lens is None else torch.from_numpy(lens))
    assert tl.shape == jl.shape == (q.shape[0], q.shape[1], q.shape[2])
    np.testing.assert_allclose(np_of(to), np_of(jo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np_of(tl), np_of(jl), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(LSE_CASES))
def test_mha_reference_lse_and_attention_lse_match_jax(name):
    """mha_reference_lse, and attention_lse on a CPU tensor, against JAX's
    mha_reference_lse (which JAX's attention_lse runs off the TPU)."""
    q, k, v, lens, causal = _lse_inputs(LSE_CASES[name], seed=1)
    jo, jl = JFA.mha_reference_lse(*_j(q, k, v), causal=causal,
                                   kv_lens=None if lens is None else jnp.asarray(lens))
    for fn in (TFA.mha_reference_lse, TFA.attention_lse):
        to, tl = fn(*_t(q, k, v), causal=causal,
                    kv_lens=None if lens is None else torch.from_numpy(lens))
        np.testing.assert_allclose(np_of(to), np_of(jo), rtol=1e-5, atol=1e-5, err_msg=fn.__name__)
        np.testing.assert_allclose(np_of(tl), np_of(jl), rtol=1e-5, atol=1e-5, err_msg=fn.__name__)


def test_rows_with_no_key_differ_as_pinned():
    """kv_len 0: the kernel's plain version gives o = 0 and lse =
    LSE_EMPTY (what the backward of row 4 needs); JAX's mha_reference_lse,
    whose l is never 0, averages every column with lse about NEG_INF, and
    the port's mha_reference_lse does the same. The pipeline never makes
    such a row: every row sees the prefix."""
    q, k, v, _, _ = _lse_inputs(LSE_CASES["causal_ragged"])
    lens = np.asarray([0, 40], np.int32)
    to, tl = TFA.flash_attention_lse(*_t(q, k, v), kv_lens=torch.from_numpy(lens))
    assert (to[0] == 0).all() and (tl[0] == TFA.LSE_EMPTY).all() and (to[1] != 0).any()
    jo, jl = JFA.mha_reference_lse(*_j(q, k, v), kv_lens=jnp.asarray(lens))
    ro, rl = TFA.mha_reference_lse(*_t(q, k, v), kv_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(np_of(jo)[0], np.broadcast_to(v.mean(axis=1)[0], jo.shape[1:]),
                               rtol=1e-5, atol=1e-5)
    assert (np_of(jl)[0] < -1e29).all()
    np.testing.assert_allclose(np_of(ro), np_of(jo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np_of(rl), np_of(jl), rtol=1e-5)


def test_merge_attention_pieces_matches_jax_and_full_attention():
    """merge_attention_pieces against JAX's, and the merge of a prefix piece
    and a causal piece against one softmax over both kv sets."""
    rng = np.random.default_rng(2)
    o1, o2 = (rng.normal(size=(2, 5, 3, 8)).astype(np.float32) for _ in range(2))
    l1, l2 = ((rng.normal(size=(2, 5, 3)) * 4).astype(np.float32) for _ in range(2))
    want = JFA.merge_attention_pieces(*_j(o1, l1, o2, l2))
    got = TFA.merge_attention_pieces(*_t(o1, l1, o2, l2))
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=1e-6, atol=1e-6)

    q, k, v, pk, pv, _ = _prefix_inputs(PREFIX_CASES["gqa_full"])
    tq, tk, tv, tpk, tpv = _t(q, k, v, pk, pv)
    merged = TFA.flash_attention_prefixed(tq, tk, tv, tpk, tpv)
    B, T, P = q.shape[0], q.shape[1], pk.shape[1]
    kk = torch.cat([tpk.expand(B, -1, -1, -1), tk], dim=1)
    vv = torch.cat([tpv.expand(B, -1, -1, -1), tv], dim=1)
    col = torch.arange(P + T)
    mask = (col[None, :] < P) | ((col[None, :] - P) <= torch.arange(T)[:, None])
    s = torch.einsum("bthd,bshd->bhts", tq, kk.repeat_interleave(2, dim=2)) / np.sqrt(q.shape[-1])
    s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
    full = torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), vv.repeat_interleave(2, dim=2))
    np.testing.assert_allclose(np_of(merged), np_of(full), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(PREFIX_CASES))
def test_flash_attention_prefixed_matches_jax(name):
    """Row 6 on a CPU tensor (its plain version: two mha_reference_lse
    pieces and a merge) against JAX's fused Pallas kernel in interpret mode
    (16-row blocks, so the prefix's last block is ragged) and against JAX's
    prefixed_attention_reference: 1e-5 in f32."""
    q, k, v, pk, pv, lens = _prefix_inputs(PREFIX_CASES[name])
    jlens = None if lens is None else jnp.asarray(lens)
    kern = JFA.flash_attention_prefixed(*_j(q, k, v, pk, pv), kv_lens=jlens, block_q=16,
                                        block_k=16, interpret=True)
    ref = JFA.prefixed_attention_reference(*_j(q, k, v, pk, pv), kv_lens=jlens)
    got = TFA.flash_attention_prefixed(*_t(q, k, v, pk, pv),
                                       kv_lens=None if lens is None else torch.from_numpy(lens))
    assert got.shape == q.shape
    np.testing.assert_allclose(np_of(got), np_of(kern), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np_of(got), np_of(ref), rtol=1e-5, atol=1e-5)


def test_prefixed_row_with_empty_rest_sees_the_prefix_only():
    """rest_len 0: the causal piece is empty, weighs 0 in the merge (its lse
    is about NEG_INF), and the row attends to the prefix alone, as the fused
    kernel's single online softmax does."""
    q, k, v, pk, pv, _ = _prefix_inputs(PREFIX_CASES["ragged"])
    lens = torch.tensor([0, 40, 3], dtype=torch.int32)
    got = TFA.flash_attention_prefixed(*_t(q, k, v, pk, pv), kv_lens=lens)
    B = q.shape[0]
    tq, _, _, tpk, tpv = _t(q, k, v, pk, pv)
    only = TFA.flash_attention_plain(tq, tpk.expand(B, -1, -1, -1).contiguous(),
                                     tpv.expand(B, -1, -1, -1).contiguous(), causal=False)
    np.testing.assert_allclose(np_of(got)[0], np_of(only)[0], rtol=1e-5, atol=1e-5)
    kern = JFA.flash_attention_prefixed(*_j(q, k, v, pk, pv), kv_lens=jnp.asarray(lens.numpy()),
                                        block_q=16, block_k=16, interpret=True)
    np.testing.assert_allclose(np_of(got), np_of(kern), rtol=1e-5, atol=1e-5)


def test_cpu_wrappers_launch_nothing():
    kernels.reset_launches()
    q, k, v, pk, pv, lens = _prefix_inputs(PREFIX_CASES["ragged"])
    TFA.flash_attention_prefixed(*_t(q, k, v, pk, pv), kv_lens=torch.from_numpy(lens))
    TFA.flash_attention_lse(*_t(q, k, v))
    TFA.attention_lse(*_t(q, k, v))
    assert kernels.LAUNCHES["flash_attention_prefixed"] == 0
    assert kernels.LAUNCHES["flash_attention_lse"] == 0


# ------------------------------------------------------------ the prefill

B, T, P = 3, 24, 7
LENS = np.asarray([24, 16, 9], np.int32)


def _llama_setup(kv_heads, quantized_weights):
    jcfg, tcfg = tiny_cfgs(kv_heads)
    p = jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    if quantized_weights:
        p = JQ.quantize_llama_params(p)
    rng = np.random.default_rng(kv_heads)
    embeds = (rng.normal(size=(B, T, jcfg.hidden_size)) * 0.5).astype(np.float32)
    embeds[1:, :P] = embeds[0, :P]  # the rows share their first P embeddings
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    return jcfg, tcfg, p, to_torch(p), embeds, positions


def _assert_cache_close(got, want):
    """f32 caches within rtol 1e-4 / atol 1e-5; an int8 cache may round
    across a .5 boundary on one side only: values within 1, at most 0.5%
    differing."""
    assert set(got) == set(want)
    for name in want:
        w, g = np.asarray(want[name]), got[name].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if g.dtype == np.int8:
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 5e-3, name
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["kv16", "kv8"])
@pytest.mark.parametrize("quantized_weights", [False, True], ids=["dense", "int8"])
def test_prefill_shared_prefix_matches_jax(kv_heads, kv_quant, quantized_weights):
    """The port's prefill_shared_prefix (per-layer quantization of the
    prefix-broadcast cache) against JAX's (which quantizes the whole cache
    at the end): logits within 1e-4, the cache as prefill_kv's test holds it."""
    jcfg, tcfg, jp, tp, embeds, positions = _llama_setup(kv_heads, quantized_weights)
    jl, jc = jllama.prefill_shared_prefix(jcfg, jp, jnp.asarray(embeds), jnp.asarray(positions),
                                          prefix_len=P, kv_lens=jnp.asarray(LENS),
                                          kv_quant=kv_quant)
    tl, tc = tllama.prefill_shared_prefix(tcfg, tp, torch.from_numpy(embeds),
                                          torch.from_numpy(positions), P,
                                          kv_lens=torch.from_numpy(LENS), kv_quant=kv_quant)
    np.testing.assert_allclose(np_of(tl), np_of(jl), rtol=1e-4, atol=1e-4)
    _assert_cache_close(tc, jc)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["kv16", "kv8"])
def test_prefill_shared_prefix_matches_prefill_kv(kv_quant):
    """On rows that do share their prefix, the shared-prefix prefill gives
    the port's own prefill_kv: logits within 1e-4, the cache as above."""
    _, tcfg, _, tp, embeds, positions = _llama_setup(2, True)
    args = (tcfg, tp, torch.from_numpy(embeds), torch.from_numpy(positions))
    want_l, want_c = tllama.prefill_kv(*args, kv_lens=torch.from_numpy(LENS), kv_quant=kv_quant)
    got_l, got_c = tllama.prefill_shared_prefix(*args, P, kv_lens=torch.from_numpy(LENS),
                                                kv_quant=kv_quant)
    np.testing.assert_allclose(np_of(got_l), np_of(want_l), rtol=1e-4, atol=1e-4)
    _assert_cache_close(got_c, want_c)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["kv16", "kv8"])
def test_generate_with_shared_prefix_matches_jax(kv_quant):
    """generate with shared_prefix_len: the same greedy tokens as JAX's
    generate with it and as the port's generate without it; entropies
    within 1e-4."""
    jcfg, tcfg, jp, tp, embeds, positions = _llama_setup(4, True)
    jkv8 = jgen._KV8
    jgen.set_kv8(kv_quant)
    tgen.set_kv8(kv_quant)
    try:
        jout = jgen.generate(jcfg, jp, jnp.asarray(embeds), jnp.asarray(positions),
                             jnp.asarray(LENS), eos_id=2, max_new_tokens=5, shared_prefix_len=P)
        targs = (tcfg, tp, torch.from_numpy(embeds), torch.from_numpy(positions),
                 torch.from_numpy(LENS))
        tout = tgen.generate(*targs, eos_id=2, max_new_tokens=5, shared_prefix_len=P)
        plain = tgen.generate(*targs, eos_id=2, max_new_tokens=5)
    finally:
        jgen.set_kv8(jkv8)
        tgen.set_kv8(None)
    np.testing.assert_array_equal(tout["tokens"].numpy(), np.asarray(jout["tokens"]))
    np.testing.assert_array_equal(tout["tokens"].numpy(), plain["tokens"].numpy())
    np.testing.assert_allclose(np_of(tout["entropy"]), np_of(jout["entropy"]), rtol=1e-4, atol=1e-4)
