"""Port parity: ops/flash_attention.py (kernel K2's plain version, the einsum
reference, the dispatcher) against revisionllm_tpu/ops/flash_attention.py,
whose Pallas kernel runs in interpret mode on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revisionllm_tpu.ops import flash_attention as JFA
from revisionllm_tpu_torch.ops import flash_attention as TFA

from torch_parity import np_of

torch.set_num_threads(2)

CASES = {
    # name: (B, T, S, H, KH, d, causal, kv_lens)
    "causal_ragged": (2, 40, 40, 4, 4, 32, True, [40, 23]),
    "gqa": (2, 40, 40, 4, 2, 32, True, [37, 40]),
    "noncausal_ragged": (2, 24, 40, 2, 2, 32, False, [40, 9]),
    "t_not_block_multiple": (1, 37, 37, 2, 1, 32, True, None),
}


@pytest.fixture(autouse=True)
def _restore_switches():
    yield
    JFA._ATTN_BF16 = None
    TFA.set_attn_bf16(None)


def _inputs(case, seed=0):
    B, T, S, H, KH, d, causal, lens = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, d)).astype(np.float32)
    k = rng.normal(size=(B, S, KH, d)).astype(np.float32)
    v = rng.normal(size=(B, S, KH, d)).astype(np.float32)
    lens = None if lens is None else np.asarray(lens, np.int32)
    return q, k, v, lens, causal


def _both(fn_j, fn_t, q, k, v, lens, causal, **jkw):
    want = fn_j(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                kv_lens=None if lens is None else jnp.asarray(lens), **jkw)
    got = fn_t(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal,
               kv_lens=None if lens is None else torch.from_numpy(lens))
    return np_of(got), np_of(want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_interpret(name):
    """K2's plain version (one softmax over the live columns) against the
    blocked online softmax of the Pallas kernel (16-row blocks, so T is split
    unevenly): f32 rounding in another order, rtol/atol 2e-5."""
    q, k, v, lens, causal = _inputs(CASES[name])
    got, want = _both(JFA.flash_attention, TFA.flash_attention, q, k, v, lens, causal,
                      block_q=16, block_k=16, interpret=True)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_and_reference_match_jax_reference(name):
    """Both port functions against JAX's mha_reference in f32 (rtol/atol 2e-5:
    same maths, f32 sums in another order)."""
    q, k, v, lens, causal = _inputs(CASES[name], seed=1)
    for fn in (TFA.flash_attention_plain, TFA.mha_reference, TFA.attention):
        got, want = _both(JFA.mha_reference, fn, q, k, v, lens, causal)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5, err_msg=fn.__name__)


def test_fully_masked_rows_give_zero_in_plain():
    """kv_lens 0: the kernel's l_safe rule gives 0 (mha_reference averages)."""
    q, k, v, _, _ = _inputs(CASES["causal_ragged"])
    got = TFA.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                    causal=True, kv_lens=torch.tensor([0, 40]))
    assert (got[0] == 0).all() and (got[1] != 0).any()


def test_bf16_scores_switch_matches_jax():
    """REVISIONLLM_ATTN_BF16 on both sides with bf16 inputs: scores and
    softmax in bf16, whose rounding points differ between XLA and torch
    (atol 3e-2 on outputs of magnitude ~1, a few bf16 steps)."""
    JFA._ATTN_BF16 = True
    TFA.set_attn_bf16(True)
    q, k, v, lens, causal = _inputs(CASES["gqa"], seed=2)
    want = JFA.mha_reference(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                             causal=causal, kv_lens=jnp.asarray(lens))
    got = TFA.mha_reference(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                            causal=causal, kv_lens=torch.from_numpy(lens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=0, atol=3e-2)


def test_bf16_switch_defaults_follow_the_device(monkeypatch):
    monkeypatch.delenv("REVISIONLLM_ATTN_BF16", raising=False)
    assert not TFA._attn_bf16_scores(torch.device("cpu"))
    assert TFA._attn_bf16_scores(torch.device("cuda"))
    monkeypatch.setenv("REVISIONLLM_ATTN_BF16", "1")
    assert TFA._attn_bf16_scores(torch.device("cpu"))
