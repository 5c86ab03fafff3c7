"""Port parity: row 4 of the kernel table (ops/flash_attention.py: the plain
versions of the forward-with-LSE, dq and dk/dv kernels, bound together as
the FlashMHA autograd Function behind trainable_attention) against
revisionllm_tpu/ops/flash_attention.py on the CPU.

The forward is held against JAX's make_flash_mha in interpret mode (the
JAX suite's own non-slow case); the gradients against jax.grad of JAX's
mha_reference, since the interpret-mode VJP is slow there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revisionllm_tpu.ops.flash_attention import make_flash_mha, mha_reference
from revisionllm_tpu_torch.ops import flash_attention as TFA
from revisionllm_tpu_torch.utils import kernels

from torch_parity import np_of

torch.set_num_threads(2)


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_and_lse_match_pallas_interpret(causal):
    """(1, 256, 2, 128): o and the per-row LSE of the Pallas forward kernel
    (interpret mode, its lane-replicated LSE read at lane 0) against
    flash_fwd_lse_plain. Both f32 with sums in another order and blockwise
    against whole-row softmax: rtol/atol 2e-5."""
    q, k, v = (_rand((1, 256, 2, 128), s) for s in (0, 1, 2))
    f = make_flash_mha(causal=causal, interpret=True)
    jo, res = f.fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None)
    jlse = np.asarray(res[5])[:, :, :256, 0]
    to, tlse = TFA.flash_fwd_lse(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 causal=causal)
    assert tlse.shape == (1, 2, 256) and tlse.dtype == torch.float32
    np.testing.assert_allclose(np_of(to), np_of(jo), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np_of(tlse), jlse, rtol=2e-5, atol=2e-5)


CASES = {
    "causal": dict(B=1, T=64, H=2, KH=2, causal=True, lens=None),
    "kv_lens": dict(B=2, T=64, H=2, KH=2, causal=True, lens=[64, 23]),
    "gqa": dict(B=2, T=48, H=4, KH=2, causal=True, lens=[48, 30]),
    "noncausal": dict(B=1, T=64, H=2, KH=1, causal=False, lens=[41]),
    "t200": dict(B=1, T=200, H=2, KH=2, causal=True, lens=[200]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_vjp_matches_jax_grad_of_mha_reference(case):
    """dq, dk, dv of trainable_attention (FlashMHA over the plain versions)
    against jax.grad of JAX's mha_reference for a random cotangent, d = 32.
    f32 on both sides, P rebuilt from the LSE against autodiff of the
    softmax: rtol/atol 1e-5 of the largest gradient. Padded kv rows (at or
    past kv_lens) get exactly zero dk and dv."""
    c = CASES[case]
    B, T, H, KH, d = c["B"], c["T"], c["H"], c["KH"], 32
    q, k, v = _rand((B, T, H, d), 3), _rand((B, T, KH, d), 4), _rand((B, T, KH, d), 5)
    w = _rand((B, T, H, d), 6)
    lens = None if c["lens"] is None else np.asarray(c["lens"], np.int32)

    def jloss(q, k, v):
        kl = None if lens is None else jnp.asarray(lens)
        return jnp.sum(mha_reference(q, k, v, causal=c["causal"], kv_lens=kl) * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    kl = None if lens is None else torch.from_numpy(lens)
    o = TFA.trainable_attention(tq, tk, tv, causal=c["causal"], kv_lens=kl)
    (o * torch.from_numpy(w)).sum().backward()
    for got, want, name in zip((tq.grad, tk.grad, tv.grad), jg, "qkv"):
        want = np.asarray(want)
        scale = np.abs(want).max()
        np.testing.assert_allclose(np_of(got), want, rtol=1e-5, atol=1e-5 * scale, err_msg=name)
    if lens is not None:
        for b, n in enumerate(lens):
            assert not tk.grad[b, n:].any() and not tv.grad[b, n:].any()


def test_plain_backward_pieces_match_autograd_of_the_plain_forward():
    """flash_dq / flash_dkv on a CPU tensor equal autograd through the plain
    forward's own maths (f64, so only the algorithm is compared)."""
    B, T, H, KH, d = 2, 24, 4, 2, 16
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, T, H, d, generator=g, dtype=torch.float64, requires_grad=True)
    k = torch.randn(B, T, KH, d, generator=g, dtype=torch.float64, requires_grad=True)
    v = torch.randn(B, T, KH, d, generator=g, dtype=torch.float64, requires_grad=True)
    do = torch.randn(B, T, H, d, generator=g, dtype=torch.float64)
    lens = torch.tensor([24, 11])
    o, lse = TFA.flash_fwd_lse_plain(q, k, v, causal=True, kv_lens=lens)
    want = torch.autograd.grad((o * do).sum(), (q, k, v))
    with torch.no_grad():
        delta = (do * o).sum(-1).transpose(1, 2).contiguous()
        dq = TFA.flash_dq(q, k, v, do, lse, delta, causal=True, kv_lens=lens)
        dk, dv = TFA.flash_dkv(q, k, v, do, lse, delta, causal=True, kv_lens=lens)
    for got, ref in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-10)


def test_flash_mha_gradcheck_f64():
    """torch.autograd.gradcheck of FlashMHA (plain versions) in f64: causal
    with kv_lens and GQA, and non-causal."""
    g = torch.Generator().manual_seed(1)
    B, T, H, KH, d = 2, 12, 4, 2, 8
    q = torch.randn(B, T, H, d, generator=g, dtype=torch.float64, requires_grad=True)
    k = torch.randn(B, T, KH, d, generator=g, dtype=torch.float64, requires_grad=True)
    v = torch.randn(B, T, KH, d, generator=g, dtype=torch.float64, requires_grad=True)
    lens = torch.tensor([12, 5])
    assert torch.autograd.gradcheck(
        lambda q, k, v: TFA.trainable_attention(q, k, v, causal=True, kv_lens=lens), (q, k, v))
    assert torch.autograd.gradcheck(
        lambda q, k, v: TFA.trainable_attention(q, k, v, causal=False), (q, k, v))


def test_rows_without_keys_get_zero_output_and_empty_lse():
    """kv_lens = 0: the kernel's l == 0 rows give o = 0 and lse = +2e30, so
    the backward's exp(s - lse) is 0 and no gradient flows."""
    q, k, v = (torch.randn(1, 8, 2, 16) for _ in range(3))
    o, lse = TFA.flash_fwd_lse(q, k, v, kv_lens=torch.tensor([0]))
    assert o.abs().max() == 0 and (lse == TFA.LSE_EMPTY).all()


def test_cpu_tensors_launch_nothing():
    kernels.reset_launches()
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    TFA.trainable_attention(q, q.detach(), q.detach()).sum().backward()
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    assert {"flash_fwd_lse", "flash_dq", "flash_dkv"} <= set(kernels.LAUNCHES)
