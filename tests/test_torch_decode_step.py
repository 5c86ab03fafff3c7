"""Port parity: the whole-step decode megakernel (ops/decode_step.py, kernel
row 9's plain version, its cache layouts) and the slice as a whole --
generate with REVISIONLLM_MEGAKERNEL=1 and REVISIONLLM_FUSED_MLP=1 --
against revisionllm_tpu on the CPU, the Pallas kernels in interpret mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import revisionllm_tpu.models.llama as jllama
from revisionllm_tpu.config import LlamaConfig as JCfg
from revisionllm_tpu.models import generation as jgen
from revisionllm_tpu.ops import decode_step as JDS
from revisionllm_tpu.ops import quant as JQ
from revisionllm_tpu.ops.rope import rope_angles
from revisionllm_tpu_torch.config import LlamaConfig as TCfg
from revisionllm_tpu_torch.models import generation as tgen
from revisionllm_tpu_torch.models import llama as tllama
from revisionllm_tpu_torch.ops import decode_step as TDS
from revisionllm_tpu_torch.ops import quant as TQ

from torch_parity import np_of, to_torch

torch.set_num_threads(2)

# tests/test_decode_step_fused.py's geometry: hidden 256, F 384, 2 heads of
# 128, 2 layers; block_f 160 leaves a ragged tail (384 = 2 x 160 + 64)
CFG = dict(vocab_size=256, hidden_size=256, intermediate_size=384, num_layers=2, num_heads=2,
           num_kv_heads=2, head_dim=128, max_position_embeddings=1024, dtype="float32")
JAX_MEGA = functools.partial(JDS.decode_step_fused, interpret=True, block_n=128, block_f=160)
JAX_MLP = functools.partial(JQ.w8a8_mlp_fused, block_m=16, block_k=32, interpret=True)


@pytest.fixture(autouse=True)
def _restore_switches(monkeypatch):
    monkeypatch.setattr(jllama, "_FUSED_MLP", None)
    yield
    for mod in (JQ, TQ):
        mod.set_w8a8(None)
    for mod in (jgen, tgen):
        mod.set_kv8(None)
        mod.set_megakernel(None)
    tllama.set_fused_mlp(None)


@pytest.fixture(scope="module")
def setup():
    """The int8 tree (lm_head too) and a KV8 prefill of 4 ragged prompts of
    40 positions (lengths 40, 37, 33, 39), in both packages' layouts."""
    jcfg = JCfg(**CFG)
    qp = JQ.quantize_llama_params(jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))
    B, S = 4, 40
    rng = np.random.default_rng(1)
    ids = jnp.asarray(rng.integers(5, 256, (B, S)), jnp.int32)
    embeds = jllama.embed_tokens(qp, ids).astype(jnp.float32)
    positions = jnp.arange(S)[None, :].repeat(B, 0)
    lens = jnp.asarray([S, S - 3, S - 7, S - 1], jnp.int32)
    _, split = jllama.prefill_kv(jcfg, qp, embeds, positions, kv_lens=lens, kv_quant=True)
    tsplit = {k: torch.from_numpy(np.array(v)) for k, v in split.items()}
    return jcfg, qp, to_torch(qp), split, tsplit, lens


def test_pack_prompt_kv_and_gen_cache_layout(setup):
    """The packed prompt cache equals JAX's on the live region (JAX pads S
    to 128 rows for the TPU's DMA, the port does not pad); the gen cache is
    JAX's [L, 2, B, KH, Gp, hd] with Gp = G rounded up to 8."""
    _, _, _, split, tsplit, _ = setup
    jp = JAX_pack = JDS.pack_prompt_kv(split)
    tp = TDS.pack_prompt_kv(tsplit)
    S = tsplit["k"].shape[2]
    assert tp["kv"].shape == JAX_pack["kv"].shape[:4] + (S, 128)
    np.testing.assert_array_equal(tp["kv"].numpy(), np.asarray(jp["kv"])[:, :, :, :, :S])
    np.testing.assert_array_equal(tp["kvsc"].numpy(), np.asarray(jp["kvsc"])[:, :, :, :, :S])
    for G in (8, 12):
        want = JDS.init_gen_cache(2, 4, 2, 128, G, jnp.float32)
        got = TDS.init_gen_cache(2, 4, 2, 128, G, torch.float32)
        assert got.shape == want.shape and not got.any()


def test_supports_megakernel_matches_jax():
    """MHA int8 trees only: GQA, dense and int4 trees take decode_step_split."""
    jcfg, tcfg = JCfg(**CFG), TCfg(**CFG)
    jgqa, tgqa = JCfg(**{**CFG, "num_kv_heads": 1}), TCfg(**{**CFG, "num_kv_heads": 1})
    dense = jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    for tree in (dense, JQ.quantize_llama_params(dense), JQ.quantize_llama_params_int4(dense)):
        ttree = to_torch(tree)
        for jc, tc in ((jcfg, tcfg), (jgqa, tgqa)):
            assert TDS.supports_megakernel(tc, ttree) == JDS.supports_megakernel(jc, tree)
    assert TDS.supports_megakernel(tcfg, to_torch(JQ.quantize_llama_params(dense)))


def test_decode_step_fused_plain_matches_pallas_interpret(setup):
    """Three steps of row 9's plain version against the Pallas kernel in
    interpret mode (block_n 128, block_f 160), fed the same embeddings each
    step. Both sides round the same values to bf16 (h, q, p1 * v_scale,
    p2, the attention output, m), but their f32 sums run in another order,
    so a value one f32 ulp from a bf16 rounding boundary can round the
    other way on one side; one such flip moves a row by about one bf16
    step of one product (measured 1.7e-3 of the largest value on this seed,
    and 5e-7 where nothing flips). So: the hidden state and the gen
    cache's live slots within 1e-2 of the largest value, and their median
    element within 1e-5 of it (the same arithmetic)."""
    jcfg, qp, tp, split, tsplit, lens = setup
    jpkv, tpkv = JDS.pack_prompt_kv(split), TDS.pack_prompt_kv(tsplit)
    G = 8
    jgen_kv = JDS.init_gen_cache(2, 4, 2, 128, G, jnp.float32)
    tgen_kv = TDS.init_gen_cache(2, 4, 2, 128, G, torch.float32)
    rng = np.random.default_rng(2)
    for s in range(3):
        x = rng.normal(size=(4, 256)).astype(np.float32)
        cos, sin = rope_angles((lens + s)[:, None], 128, jcfg.rope_theta)
        want, jgen_kv = JAX_MEGA(qp, jpkv, jgen_kv, lens, jnp.int32(s), jnp.asarray(x),
                                 cos[:, 0], sin[:, 0], eps=jcfg.rms_norm_eps)
        got, tgen_kv = TDS.decode_step_fused(
            tp, tpkv, tgen_kv, torch.from_numpy(np.array(lens)), s, torch.from_numpy(x),
            torch.from_numpy(np.array(cos[:, 0])), torch.from_numpy(np.array(sin[:, 0])),
            eps=jcfg.rms_norm_eps)
        live = np.asarray(jgen_kv)[:, :, :, :, : s + 1]
        for g, w in ((np_of(got), np_of(want)), (tgen_kv.numpy()[:, :, :, :, : s + 1], live)):
            top = np.abs(w).max()
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-2 * top)
            assert np.median(np.abs(g - w)) <= 1e-5 * top
        assert not tgen_kv[:, :, :, :, s + 1:].any()


def test_megakernel_switch(monkeypatch):
    monkeypatch.delenv("REVISIONLLM_MEGAKERNEL", raising=False)
    assert not tgen._megakernel_enabled()
    monkeypatch.setenv("REVISIONLLM_MEGAKERNEL", "1")
    assert tgen._megakernel_enabled()
    tgen.set_megakernel(False)
    assert not tgen._megakernel_enabled()


def _prompts(B, T, P, lens, seed):
    """Right-padded f32 prompts whose rows share their first P embeddings."""
    rng = np.random.default_rng(seed)
    embeds = (rng.normal(size=(B, T, 256)) * 0.5).astype(np.float32)
    embeds[:, :P] = embeds[:1, :P]
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    return embeds, positions, np.asarray(lens, np.int32)


@pytest.mark.parametrize("shared_prefix_len", [0, 9], ids=["full-prefill", "shared-prefix"])
def test_generate_with_megakernel_and_fused_mlp_matches_jax(monkeypatch, shared_prefix_len):
    """The slice as a whole: generate with REVISIONLLM_MEGAKERNEL=1 and
    REVISIONLLM_FUSED_MLP=1, W8A8 and KV8 on, in both packages (JAX's two
    kernels in interpret mode), full and shared-prefix prefill. Greedy
    tokens are identical. The int8 activation, h and KV roundings and the
    megakernel's bf16 roundings see inputs that differ in the last f32
    bits, so a value can round across a boundary on one side only (as in
    test_torch_generation's serving-numerics test): the entropy, an average
    over the vocabulary, agrees within 2e-3 (measured 8.5e-4); the chosen
    token's log-probability moves with its own logit, within 2e-2 (measured
    1.3e-2 of values near 3.8). The port
    runs row 9 for each of its G - 1 decode steps and row 8 in every
    prefill layer."""
    monkeypatch.setenv("REVISIONLLM_FUSED_MLP", "1")
    monkeypatch.setenv("REVISIONLLM_MEGAKERNEL", "1")
    monkeypatch.setattr(JDS, "decode_step_fused", JAX_MEGA)
    monkeypatch.setattr(JQ, "w8a8_mlp_fused", JAX_MLP)
    for mod in (JQ, TQ):
        mod.set_w8a8(True)
    for mod in (jgen, tgen):
        mod.set_kv8(True)
    jcfg, tcfg = JCfg(**CFG), TCfg(**CFG)
    qp = JQ.quantize_llama_params(jllama.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32))
    embeds, positions, lens = _prompts(3, 96, shared_prefix_len or 1, [96, 81, 60], seed=4)
    G = 5
    mega, mlp = [], []
    orig_mega, orig_mlp = TDS.decode_step_fused, tllama.w8a8_mlp_fused
    monkeypatch.setattr(TDS, "decode_step_fused",
                        lambda *a, **k: mega.append(1) or orig_mega(*a, **k))
    monkeypatch.setattr(tllama, "w8a8_mlp_fused", lambda *a: mlp.append(1) or orig_mlp(*a))
    j = jgen.generate(jcfg, qp, jnp.asarray(embeds), jnp.asarray(positions), jnp.asarray(lens),
                      eos_id=-1, max_new_tokens=G, shared_prefix_len=shared_prefix_len)
    t = tgen.generate(tcfg, to_torch(qp), torch.from_numpy(embeds), torch.from_numpy(positions),
                      torch.from_numpy(lens), eos_id=-1, max_new_tokens=G,
                      shared_prefix_len=shared_prefix_len)
    assert len(mega) == G - 1
    # the prefill's layers; the shared-prefix prefill runs the prefix once more
    assert len(mlp) == tcfg.num_layers * (2 if shared_prefix_len else 1)
    np.testing.assert_array_equal(t["tokens"].numpy(), np.asarray(j["tokens"]))
    np.testing.assert_array_equal(t["valid"].numpy(), np.asarray(j["valid"]))
    np.testing.assert_allclose(np_of(t["entropy"]), np_of(j["entropy"]), rtol=0, atol=2e-3)
    np.testing.assert_allclose(np_of(t["logprob"]), np_of(j["logprob"]), rtol=0, atol=2e-2)


def test_generate_takes_the_split_step_without_kv8(monkeypatch):
    """JAX's conditions carry over: with KV8 off (no k_scale) the megakernel
    switch changes nothing and decode_step_split runs."""
    monkeypatch.setenv("REVISIONLLM_MEGAKERNEL", "1")
    tgen.set_kv8(False)
    _, tcfg = JCfg(**CFG), TCfg(**CFG)
    tp = tllama.init_params(tcfg, seed=0, dtype=torch.float32, device="cpu", quantize=True)
    embeds, positions, lens = _prompts(2, 12, 1, [12, 9], seed=5)
    monkeypatch.setattr(TDS, "decode_step_fused", lambda *a, **k: pytest.fail("megakernel ran"))
    out = tgen.generate(tcfg, tp, torch.from_numpy(embeds), torch.from_numpy(positions),
                        torch.from_numpy(lens), eos_id=-1, max_new_tokens=3)
    assert out["tokens"].shape == (2, 3)
