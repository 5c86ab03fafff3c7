"""Port parity for revisionllm_tpu_torch/eval/uncertainty.py and the
pooling helpers of eval/similarity.py against the JAX package's, on the
same random inputs from one numpy seed: within 1e-5 (f32), the masked and
unmasked statistics, a one-step row and an all-masked row included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revisionllm_tpu.eval import similarity as jsim
from revisionllm_tpu.eval import uncertainty as junc
from revisionllm_tpu_torch.eval import similarity as tsim
from revisionllm_tpu_torch.eval import uncertainty as tunc

TOL = dict(rtol=1e-5, atol=1e-5)


def _logits(B=3, T=5, V=40, seed=0):
    return np.random.default_rng(seed).normal(size=(B, T, V)).astype(np.float32) * 3


def _masks():
    m = np.ones((3, 5), bool)
    m[0, 3:] = False          # eos after 3 steps
    m[1, 1:] = False          # a one-step row: std 0
    m[2, :] = False           # an all-masked row
    return m


def _close(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    # the all-masked row's max/min are the f32 extremes on both sides
    np.testing.assert_allclose(got, want, **TOL)


def test_token_entropy_matches_jax():
    x = _logits()
    _close(tunc.token_entropy(torch.from_numpy(x)), junc.token_entropy(jnp.asarray(x)))
    # bf16 logits are scored in f32 on both sides
    xb = torch.from_numpy(x).to(torch.bfloat16)
    _close(tunc.token_entropy(xb), junc.token_entropy(jnp.asarray(xb.float().numpy(),
                                                                   jnp.bfloat16)))


@pytest.mark.parametrize("masked", [False, True])
def test_entropy_statistics_matches_jax(masked):
    x = _logits(seed=1)
    m = _masks() if masked else None
    got = tunc.entropy_statistics(torch.from_numpy(x), None if m is None else torch.from_numpy(m))
    _close(got, junc.entropy_statistics(jnp.asarray(x), None if m is None else jnp.asarray(m)))
    if masked:
        assert got[1, 3] == 0.0  # one valid step: std 0


def test_entropy_statistics_one_step_matches_jax():
    x = _logits(T=1, seed=2)
    got = tunc.entropy_statistics(torch.from_numpy(x))
    _close(got, junc.entropy_statistics(jnp.asarray(x)))
    assert (got[:, 3] == 0).all()


@pytest.mark.parametrize("masked", [False, True])
def test_token_prob_statistics_matches_jax(masked):
    x = _logits(seed=3)
    toks = np.random.default_rng(4).integers(0, x.shape[-1], size=x.shape[:2])
    m = _masks() if masked else None
    got = tunc.token_prob_statistics(torch.from_numpy(x), torch.from_numpy(toks),
                                     None if m is None else torch.from_numpy(m))
    _close(got, junc.token_prob_statistics(jnp.asarray(x), jnp.asarray(toks),
                                           None if m is None else jnp.asarray(m)))


@pytest.mark.parametrize("q", [(2, 6), (4, 4)])
def test_hidden_state_helpers_match_jax(q):
    h = np.random.default_rng(5).normal(size=(4, 2, 8, 6)).astype(np.float32)
    layers = [0, 2, 3]
    _close(tunc.average_hidden_states(torch.from_numpy(h), layers, *q),
           junc.average_hidden_states(jnp.asarray(h), layers, *q))
    _close(tunc.last_token_hidden_states(torch.from_numpy(h), layers, q[1], 2),
           junc.last_token_hidden_states(jnp.asarray(h), layers, q[1], 2))


def test_pooling_helpers_match_jax():
    rng = np.random.default_rng(6)
    text = rng.normal(size=(3, 8)).astype(np.float32)
    video = rng.normal(size=(2, 7, 8)).astype(np.float32)
    spans = rng.uniform(size=(5, 2)).astype(np.float32)
    t, v = torch.from_numpy(text), torch.from_numpy(video)
    _close(tsim.topk_pooling(t, v, 3), jsim.topk_pooling(jnp.asarray(text), jnp.asarray(video), 3))
    _close(tsim.attention_pooling(t, v, 0.5),
           jsim.attention_pooling(jnp.asarray(text), jnp.asarray(video), 0.5))
    _close(tsim.span_cxw_to_xx(torch.from_numpy(spans)), jsim.span_cxw_to_xx(jnp.asarray(spans)))
