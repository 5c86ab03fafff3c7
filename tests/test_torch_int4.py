"""Port parity: the int4 weight option of ops/quant.py (kernel row 7's
plain version, quantize/unpack/dequantize, the q4 dispatch, the int4 tree
and its bridge from JAX) and stage-1 grounding on int4 weights, against
revisionllm_tpu on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revisionllm_tpu.models import llama as jllama
from revisionllm_tpu.ops import quant as JQ
from revisionllm_tpu_torch.models import llama as tllama
from revisionllm_tpu_torch.ops import quant as TQ

from torch_parity import CPU, assert_stage1_equal, engines, np_of, tiny_cfgs, to_torch

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _restore_switches():
    yield
    JQ.set_w8a8(None)
    TQ.set_w8a8(None)


def _int4(rng, K, N, lead=()):
    w = rng.normal(size=(*lead, K, N)).astype(np.float32)
    q, s = JQ.quantize_int4(jnp.asarray(w))
    return w, np.array(q), np.array(s)


def test_quantize_unpack_dequantize_bit_equal():
    """Packed nibbles, group scales, the sign-extended unpack and the
    dequantized weight (f32 and bf16) are bit-equal to JAX's, stacked
    layers and .5 ties included."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(2, 256, 40)).astype(np.float32)
    # column 0 of group 0: absmax 7 -> scale exactly 1.0, entries on ties
    w[0, :128, 0] = np.concatenate([[7.0], np.linspace(-6.5, 6.5, 127)]).astype(np.float32)
    jq, js = JQ.quantize_int4(jnp.asarray(w))
    tq, ts = TQ.quantize_int4(torch.from_numpy(w))
    assert tq.dtype == torch.uint8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert TQ.unpack_int4(tq).dtype == torch.int8
    np.testing.assert_array_equal(TQ.unpack_int4(tq).numpy(), np.asarray(JQ.unpack_int4(jq)))
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(np_of(TQ.dequantize_int4(tq, ts, tdt)),
                                      np_of(JQ.dequantize_int4(jq, js, jdt)))


@pytest.mark.parametrize("M,K,N", [(5, 384, 200), (70, 256, 130), (300, 512, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_matmul_plain_matches_pallas_interpret(M, K, N, dtype):
    """Row 7's plain version against the Pallas kernel in interpret mode:
    ragged M, K over several groups, N no multiple of the 128-column block.
    Both round q * scale to x's type and accumulate in f32, in another
    order: f32 within 1e-5 of the largest output; bf16 within one bf16 step
    (2^-8) of it."""
    rng = np.random.default_rng(M + K)
    x = rng.normal(size=(M, K)).astype(np.float32)
    _, q, s = _int4(rng, K, N)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    want = JQ.int4_matmul(jnp.asarray(x, jdt), jnp.asarray(q), jnp.asarray(s),
                          block_m=64, block_n=128, block_k=1024, interpret=True)
    got = TQ.int4_matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(q), torch.from_numpy(s))
    assert got.dtype == tdt and got.shape == (M, N)
    scale = np.abs(np_of(want)).max()
    tol = 1e-5 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=0, atol=tol * scale)


def test_q4_dispatch_follows_jax(monkeypatch):
    """q8_apply sends an int4 dict to q4_apply: M <= 256 (and every M with
    REVISIONLLM_Q4_PALLAS=all) to int4_matmul, larger M to the dequant
    route; the values equal JAX's q8_apply (its CPU route dequantizes) to
    f32 rounding (1e-5 relative), at M 64 and 300 and on stacked leading
    dims."""
    rng = np.random.default_rng(3)
    _, q, s = _int4(rng, 256, 96)
    jw = {"q4": jnp.asarray(q), "scale4": jnp.asarray(s)}
    tw = {"q4": torch.from_numpy(q), "scale4": torch.from_numpy(s)}
    calls = []
    orig = TQ.int4_matmul
    monkeypatch.setattr(TQ, "int4_matmul", lambda *a, **k: calls.append(1) or orig(*a, **k))
    for shape, env, kernel in (((64, 256), "", True), ((300, 256), "", False),
                               ((2, 150, 256), "", False), ((300, 256), "all", True)):
        monkeypatch.setenv("REVISIONLLM_Q4_PALLAS", env)
        calls.clear()
        x = rng.normal(size=shape).astype(np.float32)
        want = JQ.q8_apply(jnp.asarray(x), jw)
        got = TQ.q8_apply(torch.from_numpy(x), tw)
        assert bool(calls) == kernel, (shape, env)
        assert got.shape == shape[:-1] + (96,)
        np.testing.assert_allclose(np_of(got), np_of(want), rtol=1e-5,
                                   atol=1e-5 * np.abs(np_of(want)).max())


def test_q8_apply_multi_falls_back_per_matrix_for_int4():
    """With W8A8 on and M > 256 the shared int8 quantization applies to
    {"q8"} weights only: int4 weights take per-matrix q4_apply, as JAX's
    q8_apply_multi does (quant.py:296-313), with equal numbers."""
    JQ.set_w8a8(True)
    TQ.set_w8a8(True)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(300, 128)).astype(np.float32)
    ws = [_int4(rng, 128, n)[1:] for n in (48, 32)]
    jws = [{"q4": jnp.asarray(q), "scale4": jnp.asarray(s)} for q, s in ws]
    tws = [{"q4": torch.from_numpy(q), "scale4": torch.from_numpy(s)} for q, s in ws]
    want = JQ.q8_apply_multi(jnp.asarray(x), jws)
    got = TQ.q8_apply_multi(torch.from_numpy(x), tws)
    for g, w, tw in zip(got, want, tws):
        np.testing.assert_array_equal(g.numpy(), TQ.q8_apply(torch.from_numpy(x), tw).numpy())
        np.testing.assert_allclose(np_of(g), np_of(w), rtol=1e-5,
                                   atol=1e-5 * np.abs(np_of(w)).max())


def test_int4_tree_and_bridge_match_jax():
    """quantize_llama_params_int4 on the same f32 tree gives JAX's leaves
    bit for bit; params_from_numpy carries a JAX int4 tree across (uint8
    nibbles, f32 scale4 even when the tree is cast to bf16) and back to
    numpy unchanged; the lm_head of an int4 tree gives JAX's logits."""
    jcfg, _ = tiny_cfgs()
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    j4 = JQ.quantize_llama_params_int4(jp)
    t4 = TQ.quantize_llama_params_int4(to_torch(jp))
    bridged = to_torch(j4, torch.bfloat16)
    for name in tllama.LAYER_MATRICES:
        for key in ("q4", "scale4"):
            want = np.asarray(j4["layers"][name][key])
            np.testing.assert_array_equal(t4["layers"][name][key].numpy(), want)
            np.testing.assert_array_equal(bridged["layers"][name][key].numpy(), want)
        assert bridged["layers"][name]["q4"].dtype == torch.uint8
        assert bridged["layers"][name]["scale4"].dtype == torch.float32
    assert bridged["embed"].dtype == torch.bfloat16
    h = np.random.default_rng(5).normal(size=(3, jcfg.hidden_size)).astype(np.float32)
    want = jllama.logits_from_hidden(j4, jnp.asarray(h))
    got = tllama.logits_from_hidden(t4, torch.from_numpy(h))
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=1e-5, atol=1e-5)


def test_init_params_int4_draws_group_128_trees():
    """init_params(quantize="int4") holds {"q4", "scale4"} leaves of the
    int4 shapes (the lm_head too, unless quantize_lm_head=False), each the
    int4 quantization of the matrix the dense init draws from the seed."""
    _, tcfg = tiny_cfgs()
    dense = tllama.init_params(tcfg, seed=3, dtype=torch.float32, device=CPU)
    p4 = tllama.init_params(tcfg, seed=3, dtype=torch.float32, device=CPU, quantize="int4")
    D, F = tcfg.hidden_size, tcfg.intermediate_size
    assert p4["layers"]["down_proj"]["q4"].shape == (tcfg.num_layers, F // 2, D)
    assert p4["layers"]["down_proj"]["scale4"].shape == (tcfg.num_layers, F // 128, D)
    for name in ("q_proj", "down_proj"):
        q, s = TQ.quantize_int4(dense["layers"][name])
        assert torch.equal(p4["layers"][name]["q4"], q)
        assert torch.equal(p4["layers"][name]["scale4"], s)
    assert torch.equal(p4["lm_head"]["q4"], TQ.quantize_int4(dense["lm_head"])[0])
    no_head = tllama.init_params(tcfg, seed=3, dtype=torch.float32, device=CPU, quantize="int4",
                                 quantize_lm_head=False)
    assert torch.equal(no_head["lm_head"], dense["lm_head"])


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
def test_ground_windows_on_int4_weights_matches_jax(kv_heads):
    """Stage-1 grounding on an int4 tree (quantize_llama_params_int4, the
    lm_head too) in both packages: identical answers and frames, scores
    within 1e-4 (tests/test_engine_batch.py's measure). The port's decode
    matmuls take row 7's plain version (M <= 256), JAX's the dequant route:
    the same f32 products."""
    rng = np.random.default_rng(0)
    movie = rng.normal(size=(400, 16)).astype(np.float32)
    qf = rng.normal(size=(3, 16)).astype(np.float32)
    qc = rng.normal(size=(16,)).astype(np.float32)
    qc /= np.linalg.norm(qc)
    jeng, teng = engines(kv_heads=kv_heads, quantize=JQ.quantize_llama_params_int4)
    assert "q4" in teng.params["layers"]["q_proj"] and "q4" in teng.params["lm_head"]
    want = jeng.ground_windows(movie, "a red car drives by.", qf, qc)
    got = teng.ground_windows(movie, "a red car drives by.", qf, qc, movie_key="m")
    assert got["num_windows"] == 19
    assert_stage1_equal(want, got)
