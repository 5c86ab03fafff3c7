"""Port parity: the fused W8A8 MLP tail (REVISIONLLM_FUSED_MLP) -- kernel
row 8's plain version, quantize_activation_rows, w8a8_prequant_matmul and
models/llama.py's fused _mlp_block branch -- against revisionllm_tpu on the
CPU, its Pallas kernel in interpret mode."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import revisionllm_tpu.models.llama as jllama
from revisionllm_tpu.ops import quant as JQ
from revisionllm_tpu_torch.models import llama as tllama
from revisionllm_tpu_torch.ops import quant as TQ

from torch_parity import np_of

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _restore_switches(monkeypatch):
    monkeypatch.setattr(jllama, "_FUSED_MLP", None)
    yield
    JQ.set_w8a8(None)
    TQ.set_w8a8(None)
    tllama.set_fused_mlp(None)


def _operands(rng, M, K, N):
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    xs = (np.abs(rng.normal(size=(M, 1))) * 0.01 + 1e-3).astype(np.float32)
    gq = rng.integers(-127, 128, (K, N)).astype(np.int8)
    uq = rng.integers(-127, 128, (K, N)).astype(np.int8)
    gs = (np.abs(rng.normal(size=(N,))) * 2e-3 + 1e-4).astype(np.float32)
    us = (np.abs(rng.normal(size=(N,))) * 2e-3 + 1e-4).astype(np.float32)
    return xq, xs, gq, gs, uq, us


@pytest.mark.parametrize("M,K,N", [(37, 80, 256), (130, 96, 160), (5, 48, 32)])
def test_w8a8_mlp_fused_plain_matches_pallas_interpret(M, K, N):
    """Row 8's plain version against the Pallas kernel (interpret mode,
    block_m 16, block_k 32, so M and K are padded) by the JAX test's measure
    (tests/test_quant.py:392-410): hs to 1e-6 relative, hq within +-1 and at
    least 99.9% equal (exp may differ in the last bit, which can move a
    value across a rounding boundary)."""
    ops = _operands(np.random.default_rng(M), M, K, N)
    hq, hs = JQ.w8a8_mlp_fused(*map(jnp.asarray, ops), block_m=16, block_k=32, interpret=True)
    thq, ths = TQ.w8a8_mlp_fused(*map(torch.from_numpy, ops))
    assert thq.dtype == torch.int8 and thq.shape == (M, N) and ths.shape == (M, 1)
    np.testing.assert_allclose(ths.numpy(), np.asarray(hs), rtol=1e-6)
    diff = np.abs(thq.numpy().astype(int) - np.asarray(hq, int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


def test_quantize_activation_rows_and_prequant_matmul_match_jax():
    """The per-row activation quantization is bit-equal; the int8 product
    of an already-quantized activation agrees to the last f32 rescale
    (1e-6), at M above and below 16."""
    rng = np.random.default_rng(7)
    for M in (300, 9):
        x = rng.normal(size=(M, 64)).astype(np.float32)
        jq, js = JQ.quantize_activation_rows(jnp.asarray(x))
        tq, ts = TQ.quantize_activation_rows(torch.from_numpy(x))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        wq, wsc = JQ.quantize_int8(jnp.asarray(rng.normal(size=(64, 48)).astype(np.float32)))
        want = JQ.w8a8_prequant_matmul(jq, js, wq, wsc, out_dtype=jnp.float32)
        got = TQ.w8a8_prequant_matmul(tq, ts, torch.from_numpy(np.array(wq)),
                                      torch.from_numpy(np.array(wsc)), out_dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _layer(rng, D, F):
    lp = {}
    for name, (k, n) in {"gate_proj": (D, F), "up_proj": (D, F), "down_proj": (F, D)}.items():
        q, s = JQ.quantize_int8(jnp.asarray(rng.normal(size=(k, n)) * 0.05, jnp.float32))
        lp[name] = {"q8": q, "scale": s}
    return lp


@pytest.mark.parametrize("M", [48, 300], ids=["decode-size", "prefill-size"])
def test_fused_mlp_block_matches_jax(monkeypatch, M):
    """REVISIONLLM_FUSED_MLP=1 in both packages routes _mlp_block through
    the fused tail, whatever W8A8 and M say (JAX's branch checks neither).
    The port's tail equals JAX's (the Pallas kernel in interpret mode) to
    one int8 step of h on the rare element where exp's last bit moves the
    rounding: within 1e-3 of the largest output (measured 0 on this seed);
    both stay within 5% of the unfused chain, as the JAX test holds."""
    monkeypatch.setenv("REVISIONLLM_FUSED_MLP", "1")
    monkeypatch.setattr(JQ, "w8a8_mlp_fused", functools.partial(
        JQ.w8a8_mlp_fused, block_m=16, block_k=32, interpret=True))
    JQ.set_w8a8(True)
    TQ.set_w8a8(True)
    rng = np.random.default_rng(5)
    D, F = 64, 128
    x = (rng.normal(size=(2, M // 2, D)) * 0.3).astype(np.float32)
    lp = _layer(rng, D, F)
    tlp = {n: {k: torch.from_numpy(np.array(v)) for k, v in w.items()} for n, w in lp.items()}
    calls = []
    orig = tllama.w8a8_mlp_fused
    monkeypatch.setattr(tllama, "w8a8_mlp_fused", lambda *a: calls.append(1) or orig(*a))
    want = np.asarray(jllama._mlp_block(lp, None, 0.0, jnp.asarray(x)), np.float64)
    got = np_of(tllama._mlp_block(tlp, torch.from_numpy(x)))
    assert calls == [1] and got.shape == x.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-3 * scale
    tllama.set_fused_mlp(False)
    chain = np_of(tllama._mlp_block(tlp, torch.from_numpy(x)))
    assert calls == [1]
    assert np.abs(got - chain).max() / scale < 0.05


def test_fused_mlp_switch(monkeypatch):
    """Off by default, REVISIONLLM_FUSED_MLP=1 turns it on, set_fused_mlp
    overrides the environment; int4 or dense weights never take it."""
    monkeypatch.delenv("REVISIONLLM_FUSED_MLP", raising=False)
    assert not tllama._fused_mlp_enabled()
    monkeypatch.setenv("REVISIONLLM_FUSED_MLP", "1")
    assert tllama._fused_mlp_enabled()
    tllama.set_fused_mlp(False)
    assert not tllama._fused_mlp_enabled()
    tllama.set_fused_mlp(True)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(4, 128)).astype(np.float32))
    lp4 = {}
    for name, (k, n) in {"gate_proj": (128, 256), "up_proj": (128, 256),
                         "down_proj": (256, 128)}.items():
        q, s = TQ.quantize_int4(torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)))
        lp4[name] = {"q4": q, "scale4": s}
    calls = []
    monkeypatch.setattr(tllama, "w8a8_mlp_fused", lambda *a: calls.append(1))
    out = tllama._mlp_block(lp4, x)
    assert calls == [] and out.shape == (4, 128)
