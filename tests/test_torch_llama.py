"""Port parity: models/llama.py (prefill_kv, decode_step_split), the norms,
rope and the weight hand-over, against revisionllm_tpu on the CPU, on
weights made by JAX and carried across by models/weights.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revisionllm_tpu.models import llama as jllama
from revisionllm_tpu.ops import norms as jnorms
from revisionllm_tpu.ops import quant as JQ
from revisionllm_tpu.ops import rope as jrope
from revisionllm_tpu_torch.models import llama as tllama
from revisionllm_tpu_torch.models.weights import params_from_numpy
from revisionllm_tpu_torch.ops import norms as tnorms
from revisionllm_tpu_torch.ops import rope as trope

from torch_parity import CPU, np_of, tiny_cfgs, to_torch

torch.set_num_threads(2)

B, T, G = 3, 20, 4
LENS = np.asarray([20, 13, 7], np.int32)


def _setup(kv_heads, quantized_weights):
    jcfg, tcfg = tiny_cfgs(kv_heads)
    p = jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    if quantized_weights:
        p = JQ.quantize_llama_params(p)
    rng = np.random.default_rng(kv_heads)
    embeds = (rng.normal(size=(B, T, jcfg.hidden_size)) * 0.5).astype(np.float32)
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    return jcfg, tcfg, p, to_torch(p), embeds, positions


def test_norms_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w, b = rng.normal(size=(64,)).astype(np.float32), rng.normal(size=(64,)).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(np_of(tnorms.rms_norm(t(x), t(w))), np_of(jnorms.rms_norm(x, w)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np_of(tnorms.layer_norm(t(x), t(w), t(b))), np_of(jnorms.layer_norm(x, w, b)), rtol=1e-5, atol=1e-5)
    pos = np.asarray([[0, 1, 2, 300, 4095]], np.int32)
    jc, js = jrope.rope_angles(jnp.asarray(pos), 64)
    tc, ts = trope.rope_angles(t(pos), 64)
    # angles up to 4095 rad: f32 pow/cos/sin differ by an ulp or two
    np.testing.assert_allclose(np_of(tc), np_of(jc), rtol=0, atol=2e-4)
    np.testing.assert_allclose(np_of(ts), np_of(js), rtol=0, atol=2e-4)
    xr = rng.normal(size=(1, 5, 2, 64)).astype(np.float32)
    np.testing.assert_allclose(np_of(trope.apply_rope(t(xr), tc, ts)), np_of(jrope.apply_rope(xr, jc, js)), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["kv16", "kv8"])
@pytest.mark.parametrize("quantized_weights", [False, True], ids=["dense", "int8"])
def test_prefill_kv_matches_jax(kv_heads, kv_quant, quantized_weights):
    """f32 throughout; sums in another order (and, for int8 weights at
    M <= 256, K1's (x @ q) * s against JAX's x @ (q * s)): logits within
    rtol/atol 1e-4. An int8 cache may round across a .5 boundary on one side
    only: values within 1, at most 0.5% of them differing."""
    jcfg, tcfg, jp, tp, embeds, positions = _setup(kv_heads, quantized_weights)
    jl, jc = jllama.prefill_kv(jcfg, jp, jnp.asarray(embeds), jnp.asarray(positions),
                               kv_lens=jnp.asarray(LENS), kv_quant=kv_quant)
    tl, tc = tllama.prefill_kv(tcfg, tp, torch.from_numpy(embeds), torch.from_numpy(positions),
                               kv_lens=torch.from_numpy(LENS), kv_quant=kv_quant)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(np_of(tl), np_of(jl), rtol=1e-4, atol=1e-4)
    assert set(tc) == set(jc)
    for name in jc:
        want, got = np.asarray(jc[name]), tc[name].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if got.dtype == np.int8:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 5e-3, name
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["kv16", "kv8"])
def test_decode_step_split_matches_jax(kv_heads, kv_quant):
    """Both sides decode 3 steps from the SAME prompt cache (JAX's), so the
    attention over [int8 or f32 prompt | gen] (kernel K3's plain version) is
    held against llama.py:686-749: logits and gen caches within 1e-4."""
    jcfg, tcfg, jp, tp, embeds, positions = _setup(kv_heads, quantized_weights=True)
    _, jc = jllama.prefill_kv(jcfg, jp, jnp.asarray(embeds), jnp.asarray(positions),
                              kv_lens=jnp.asarray(LENS), kv_quant=kv_quant)
    tc = params_from_numpy(jax.tree.map(np.asarray, jc), CPU)
    shape = (jcfg.num_layers, B, G, jcfg.num_kv_heads, jcfg.head_dim)
    jg = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tg = tllama.init_gen_cache(tcfg, B, G, torch.float32, CPU)
    rng = np.random.default_rng(5)
    for step in range(3):
        te = (rng.normal(size=(B, 1, jcfg.hidden_size)) * 0.5).astype(np.float32)
        jl, jg = jllama.decode_step_split(jcfg, jp, jc, jnp.asarray(LENS), jg,
                                          jnp.asarray(step, jnp.int32), jnp.asarray(te))
        tl, tg = tllama.decode_step_split(tcfg, tp, tc, torch.from_numpy(LENS), tg, step,
                                          torch.from_numpy(te))
        np.testing.assert_allclose(np_of(tl), np_of(jl), rtol=1e-4, atol=1e-4, err_msg=f"step {step}")
    for name in ("k", "v"):
        np.testing.assert_allclose(np_of(tg[name]), np_of(jg[name]), rtol=1e-4, atol=1e-5)


def test_quantize_prompt_kv_matches_jax():
    rng = np.random.default_rng(1)
    kv = {n: rng.normal(size=(2, 2, 5, 2, 16)).astype(np.float32) for n in ("k", "v")}
    want = jllama.quantize_prompt_kv({n: jnp.asarray(a) for n, a in kv.items()})
    got = tllama.quantize_prompt_kv({n: torch.from_numpy(a) for n, a in kv.items()})
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


def test_params_from_numpy_keeps_bf16_bits_and_int8():
    """JAX bf16 arrays come to numpy as ml_dtypes.bfloat16, which
    torch.from_numpy rejects; the bits move as uint16."""
    jcfg, tcfg = tiny_cfgs()
    p = JQ.quantize_llama_params(jllama.init_params(jcfg, jax.random.PRNGKey(2), jnp.bfloat16))
    tp = to_torch(p)
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["embed"].view(torch.int16).numpy(),
                                  np.asarray(p["embed"]).view(np.int16))
    assert tp["layers"]["q_proj"]["q8"].dtype == torch.int8
    np.testing.assert_array_equal(tp["layers"]["q_proj"]["q8"].numpy(), np.asarray(p["layers"]["q_proj"]["q8"]))
    cast = to_torch(p, dtype=torch.float32)
    assert cast["embed"].dtype == torch.float32
    assert cast["layers"]["q_proj"]["scale"].dtype == torch.float32
    assert cast["layers"]["q_proj"]["q8"].dtype == torch.int8


def test_init_params_quantized_matches_quantizing_after():
    """quantize=True (one layer at a time) gives the tree quantize_llama_params
    makes from the same draws."""
    _, tcfg = tiny_cfgs()
    dense = tllama.init_params(tcfg, seed=3, dtype=torch.float32, device="cpu")
    q = tllama.init_params(tcfg, seed=3, dtype=torch.float32, device="cpu", quantize=True)
    from revisionllm_tpu_torch.ops.quant import quantize_llama_params

    want = quantize_llama_params(dense)
    np.testing.assert_array_equal(q["embed"].numpy(), dense["embed"].numpy())
    for name in ("q_proj", "down_proj"):
        np.testing.assert_array_equal(q["layers"][name]["q8"].numpy(), want["layers"][name]["q8"].numpy())
    np.testing.assert_array_equal(q["lm_head"]["q8"].numpy(), want["lm_head"]["q8"].numpy())
