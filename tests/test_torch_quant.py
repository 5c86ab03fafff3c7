"""Port parity: ops/quant.py (kernel K1's plain version, W8A8, dispatch)
against revisionllm_tpu/ops/quant.py on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revisionllm_tpu.ops import quant as JQ
from revisionllm_tpu_torch.ops import quant as TQ

from torch_parity import np_of

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _restore_switches():
    yield
    JQ.set_w8a8(None)
    TQ.set_w8a8(None)
    JQ.set_exact_trace(False)
    TQ.set_exact_trace(False)


def _quantized(rng, K, N):
    w = rng.normal(size=(K, N)).astype(np.float32)
    q, s = JQ.quantize_int8(jnp.asarray(w))
    return np.array(q), np.array(s)


def test_quantize_int8_bit_equal_including_ties():
    """Division then round-half-to-even: int8 values and scales must be
    bit-equal to JAX's (ties at x.5 included)."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 64, 48)).astype(np.float32)
    # column 0: absmax 127 -> scale exactly 1.0, entries on .5 ties
    w[0, :, 0] = np.concatenate([[127.0], np.arange(63, dtype=np.float32) - 31.5])
    jq, js = JQ.quantize_int8(jnp.asarray(w))
    tq, ts = TQ.quantize_int8(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        TQ.dequantize_int8(tq, ts, torch.float32).numpy(),
        np.asarray(JQ.dequantize_int8(jq, js, jnp.float32)),
    )


@pytest.mark.parametrize("M,K,N", [(1, 128, 256), (8, 256, 128), (64, 128, 384)])
def test_int8_matmul_plain_matches_pallas_interpret(M, K, N):
    """K1's plain version against the Pallas kernel in interpret mode. Both
    accumulate exact int8 x f32 products in f32, in another order: f32
    rounding tolerance (rtol/atol 1e-5)."""
    rng = np.random.default_rng(M)
    x = rng.normal(size=(M, K)).astype(np.float32)
    q, s = _quantized(rng, K, N)
    want = JQ.int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                          block_n=128, block_k=128, interpret=True)
    got = TQ.int8_matmul(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=1e-5, atol=1e-5)


def test_int8_matmul_flattens_leading_dims():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 128)).astype(np.float32)
    q, s = _quantized(rng, 128, 64)
    got = TQ.int8_matmul(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s))
    flat = TQ.int8_matmul(torch.from_numpy(x.reshape(6, 128)), torch.from_numpy(q), torch.from_numpy(s))
    assert got.shape == (2, 3, 64)
    np.testing.assert_array_equal(got.reshape(6, 64).numpy(), flat.numpy())


def test_w8a8_matches_jax():
    """Per-row int8 activations are bit-equal and the int32 accumulation is
    exact, so the outputs agree to the last f32 rescale (rtol 1e-6)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(300, 256)).astype(np.float32)
    q, s = _quantized(rng, 256, 128)
    want = JQ.w8a8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s))
    got = TQ.w8a8_matmul(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s))
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=1e-6, atol=1e-6)
    xq, _ = TQ.quantize_activation_rows(torch.from_numpy(x))
    xf = x.astype(np.float32)
    absmax = np.abs(xf).max(-1, keepdims=True)
    jxq = np.asarray(jnp.clip(jnp.round(jnp.asarray(xf) / jnp.asarray(absmax / 127.0)), -127, 127))
    np.testing.assert_array_equal(xq.numpy(), jxq.astype(np.int8))


@pytest.mark.parametrize("w8a8", [False, True])
@pytest.mark.parametrize("M", [64, 300])
def test_q8_apply_dispatch_matches_jax(w8a8, M):
    """Same switches on both sides. M <= 256: the port's K1 plain version
    against JAX's CPU route (exact dequant then matmul) -- the same maths in
    another rounding order (rtol/atol 1e-5). M > 256: W8A8 or exact dequant
    on both sides (rtol/atol 1e-6)."""
    JQ.set_w8a8(w8a8)
    TQ.set_w8a8(w8a8)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(M, 128)).astype(np.float32)
    q, s = _quantized(rng, 128, 192)
    want = JQ.q8_apply(jnp.asarray(x), {"q8": jnp.asarray(q), "scale": jnp.asarray(s)})
    got = TQ.q8_apply(torch.from_numpy(x), {"q8": torch.from_numpy(q), "scale": torch.from_numpy(s)})
    tol = 1e-5 if M <= 256 else 1e-6
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=tol, atol=tol)


def test_q8_apply_multi_is_bit_exact_with_separate_calls():
    TQ.set_w8a8(True)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(2, 200, 128)).astype(np.float32))
    ws = [dict(zip(("q8", "scale"), map(torch.from_numpy, _quantized(rng, 128, n)))) for n in (64, 96)]
    shared = TQ.q8_apply_multi(x, ws)
    for got, w in zip(shared, ws):
        np.testing.assert_array_equal(got.numpy(), TQ.q8_apply(x, w).numpy())


def test_quantize_llama_params_matches_jax():
    from revisionllm_tpu.config import LlamaConfig
    from revisionllm_tpu.models import llama as jllama
    from torch_parity import to_torch

    cfg = LlamaConfig.tiny()
    p = jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    want = JQ.quantize_llama_params(p)
    got = TQ.quantize_llama_params(to_torch(p))
    for name in ("q_proj", "down_proj"):
        np.testing.assert_array_equal(got["layers"][name]["q8"].numpy(), np.asarray(want["layers"][name]["q8"]))
        np.testing.assert_array_equal(got["layers"][name]["scale"].numpy(), np.asarray(want["layers"][name]["scale"]))
    np.testing.assert_array_equal(got["lm_head"]["q8"].numpy(), np.asarray(want["lm_head"]["q8"]))


def _jw(qs):
    return [{"q8": jnp.asarray(q), "scale": jnp.asarray(s)} for q, s in qs]


def _tw(qs):
    return [{"q8": torch.from_numpy(q), "scale": torch.from_numpy(s)} for q, s in qs]


@pytest.mark.parametrize("multi", [False, True], ids=["q8_apply", "q8_apply_multi"])
def test_w8a8_gradient_is_jax_straight_through(multi):
    """W8A8 on both sides, M = 300 > 256: the gradient to x is JAX's
    straight-through g dequant(W)^T (summed over the matrices in f32 for
    q8_apply_multi), equal within f32 rounding (rtol/atol 1e-5). Without
    it, autograd saw only the path through the absmax scale."""
    JQ.set_w8a8(True)
    TQ.set_w8a8(True)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(300, 64)).astype(np.float32)
    qs = [_quantized(rng, 64, n) for n in (48, 32)]
    wts = rng.normal(size=(2,)).astype(np.float32) + 2.0

    def jloss(x):
        outs = JQ.q8_apply_multi(x, _jw(qs)) if multi else (JQ.q8_apply(x, _jw(qs)[0]),)
        return sum((o * w).sum() for o, w in zip(outs, wts))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    outs = TQ.q8_apply_multi(xt, _tw(qs)) if multi else (TQ.q8_apply(xt, _tw(qs)[0]),)
    sum((o * float(w)).sum() for o, w in zip(outs, wts)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("M", [64, 300])
def test_exact_trace_takes_the_dequant_route(M):
    """set_exact_trace(True), even with W8A8 on: q8_apply and q8_apply_multi
    compute x @ dequant(W) on any M, and its gradient, as JAX's exact trace
    does (rtol/atol 1e-5)."""
    JQ.set_w8a8(True)
    TQ.set_w8a8(True)
    JQ.set_exact_trace(True)
    TQ.set_exact_trace(True)
    rng = np.random.default_rng(M)
    x = rng.normal(size=(M, 64)).astype(np.float32)
    qs = [_quantized(rng, 64, n) for n in (48, 32)]
    xt = torch.from_numpy(x).requires_grad_()
    outs = TQ.q8_apply_multi(xt, _tw(qs))
    want = [np.asarray(o) for o in JQ.q8_apply_multi(jnp.asarray(x), _jw(qs))]
    for got, w, (q, s) in zip(outs, want, qs):
        np.testing.assert_allclose(np_of(got), w, rtol=1e-5, atol=1e-5)
        deq = TQ.dequantize_int8(torch.from_numpy(q), torch.from_numpy(s), torch.float32)
        torch.testing.assert_close(got, torch.from_numpy(x) @ deq, rtol=0, atol=0)
    sum(o.sum() for o in outs).backward()
    jg = jax.grad(lambda x: sum(o.sum() for o in JQ.q8_apply_multi(x, _jw(qs))))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5)


def test_forbid_grad_raises_only_while_recording():
    from revisionllm_tpu_torch.utils import kernels

    a = torch.ones(3, requires_grad=True)
    b = torch.ones(3)
    kernels.forbid_grad("k", b, None, 3)
    with pytest.raises(RuntimeError, match="k: this kernel has no backward"):
        kernels.forbid_grad("k", b, a)
    with torch.no_grad():
        kernels.forbid_grad("k", b, a)


def test_quantize_llama_params_host_matches_jax():
    """The NumPy host quantizer and the torch one give JAX's int8 values and
    scales; quantize_lm_head=False keeps a dense lm_head."""
    from revisionllm_tpu.config import LlamaConfig
    from revisionllm_tpu.models import llama as jllama
    from torch_parity import to_torch

    cfg = LlamaConfig.tiny()
    p = jax.tree.map(np.asarray, jllama.init_params(cfg, jax.random.PRNGKey(1), jnp.float32))
    want = JQ.quantize_llama_params_host(p, quantize_lm_head=False)
    got = TQ.quantize_llama_params_host(p, quantize_lm_head=False)
    dev = TQ.quantize_llama_params(to_torch(p), quantize_lm_head=False)
    for name in ("k_proj", "up_proj"):
        for key in ("q8", "scale"):
            np.testing.assert_array_equal(got["layers"][name][key], want["layers"][name][key])
            np.testing.assert_array_equal(dev["layers"][name][key].numpy(), want["layers"][name][key])
    assert not isinstance(got["lm_head"], dict) and not isinstance(dev["lm_head"], dict)

