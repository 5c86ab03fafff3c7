"""Port parity: ops/decode_attention.py (kernel K3's plain version) against
revisionllm_tpu/ops/decode_attention.py (its einsum reference, and its
Pallas kernel in interpret mode for group == 1). The port keeps the cache's
own [B, S, KH, hd] layout; the JAX functions take head-major caches, so the
test transposes for them. The int8 path of decode_step_split is held
against JAX in test_torch_llama.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revisionllm_tpu.ops import decode_attention as JDA
from revisionllm_tpu_torch.ops import decode_attention as TDA

from torch_parity import np_of

torch.set_num_threads(2)


def _inputs(B, KH, group, hd, S, G, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, KH, group, hd)).astype(np.float32)
    pk, pv = (rng.normal(size=(B, S, KH, hd)).astype(np.float32) for _ in range(2))
    gk, gv = (rng.normal(size=(B, G, KH, hd)).astype(np.float32) for _ in range(2))
    return q, pk, pv, gk, gv


def _head_major(x):
    return jnp.asarray(np.ascontiguousarray(np.swapaxes(x, 1, 2)))


def _port(q, pk, pv, gk, gv, lens, step, ks=None, vs=None):
    t = torch.from_numpy
    return TDA.decode_attention(
        t(q), t(pk), t(pv), None if ks is None else t(ks), None if vs is None else t(vs),
        t(gk), t(gv), t(np.asarray(lens, np.int32)), step,
    )


@pytest.mark.parametrize("group,step", [(1, 3), (4, 0), (2, 5)])
def test_plain_matches_jax_reference(group, step):
    """f32 caches: the same two-piece softmax, f32 sums in another order
    (rtol/atol 2e-5)."""
    B, KH, hd, S, G = 3, 2, 32, 20, 6
    q, pk, pv, gk, gv = _inputs(B, KH, group, hd, S, G, seed=group)
    lens = [20, 7, 1]
    want = JDA.decode_attention_reference(
        jnp.asarray(q), _head_major(pk), _head_major(pv), _head_major(gk), _head_major(gv),
        jnp.asarray(lens, jnp.int32), jnp.asarray(step, jnp.int32),
    )
    got = _port(q, pk, pv, gk, gv, lens, step)
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=2e-5, atol=2e-5)


def test_plain_matches_pallas_interpret():
    """group == 1, hd 128 (the Pallas kernel's own case), interpret mode."""
    B, KH, hd, S, G = 2, 8, 128, 24, 4
    q, pk, pv, gk, gv = _inputs(B, KH, 1, hd, S, G, seed=7)
    lens = [24, 11]
    want = JDA.decode_attention(
        jnp.asarray(q), _head_major(pk), _head_major(pv), _head_major(gk), _head_major(gv),
        jnp.asarray(lens, jnp.int32), jnp.asarray(2, jnp.int32), interpret=True,
    )
    got = _port(q, pk, pv, gk, gv, lens, 2)
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=2e-5, atol=2e-5)


def test_int8_prompt_equals_dequantized_reference():
    """Int8 prompt k/v with per-(position, head) scales folded into the
    score and the probability equal attention over the dequantized cache
    (f32; the folding reorders one product, rtol/atol 2e-5)."""
    B, KH, group, hd, S, G = 2, 2, 2, 32, 16, 4
    q, _, _, gk, gv = _inputs(B, KH, group, hd, S, G, seed=9)
    rng = np.random.default_rng(10)
    pk8, pv8 = (rng.integers(-127, 128, size=(B, S, KH, hd)).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.01, 0.05, size=(B, S, KH)).astype(np.float32) for _ in range(2))
    lens = [16, 5]
    got = _port(q, pk8, pv8, gk, gv, lens, 1, ks, vs)
    want = JDA.decode_attention_reference(
        jnp.asarray(q), _head_major(pk8.astype(np.float32) * ks[..., None]),
        _head_major(pv8.astype(np.float32) * vs[..., None]), _head_major(gk), _head_major(gv),
        jnp.asarray(lens, jnp.int32), jnp.asarray(1, jnp.int32),
    )
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=2e-5, atol=2e-5)


def test_future_gen_slots_and_masked_prompt_do_not_leak():
    B, KH, group, hd, S, G = 2, 1, 1, 32, 12, 5
    q, pk, pv, gk, gv = _inputs(B, KH, group, hd, S, G, seed=11)
    lens = [12, 4]
    a = _port(q, pk, pv, gk, gv, lens, 1)
    gk2, pk2 = gk.copy(), pk.copy()
    gk2[:, 2:] = 1e4
    pk2[1, 4:] = 1e4
    b = _port(q, pk2, pv, gk2, gv, lens, 1)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
