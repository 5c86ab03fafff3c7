"""Port parity: models/generation.py (generate, entropy stats, the serving
switches) against revisionllm_tpu/models/generation.py on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revisionllm_tpu.models import generation as jgen
from revisionllm_tpu.models import llama as jllama
from revisionllm_tpu.ops import quant as JQ
from revisionllm_tpu_torch.models import generation as tgen
from revisionllm_tpu_torch.models import llama as tllama
from revisionllm_tpu_torch.ops import quant as TQ

from torch_parity import np_of, tiny_cfgs, to_torch

torch.set_num_threads(2)

G = 6


@pytest.fixture(autouse=True)
def _restore_switches():
    yield
    for mod in (JQ, TQ):
        mod.set_w8a8(None)
    for mod in (jgen, tgen):
        mod.set_kv8(None)


def _inputs(jcfg, B, T, lens, seed):
    rng = np.random.default_rng(seed)
    embeds = (rng.normal(size=(B, T, jcfg.hidden_size)) * 0.5).astype(np.float32)
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    return embeds, positions, np.asarray(lens, np.int32)


def _run_both(jcfg, tcfg, jp, tp, embeds, positions, lens, eos_id):
    j = jgen.generate(jcfg, jp, jnp.asarray(embeds), jnp.asarray(positions), jnp.asarray(lens),
                      eos_id=eos_id, max_new_tokens=G)
    t = tgen.generate(tcfg, tp, torch.from_numpy(embeds), torch.from_numpy(positions),
                      torch.from_numpy(lens), eos_id=eos_id, max_new_tokens=G)
    return j, t


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
def test_greedy_generate_matches_jax(kv_heads):
    """f32: identical greedy tokens and validity, entropy and logprob within
    1e-4 (f32 sums in another order). The eos id is the token JAX emits for
    row 0 at step 1, so eos masking is exercised."""
    jcfg, tcfg = tiny_cfgs(kv_heads)
    jp = JQ.quantize_llama_params(jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))
    tp = to_torch(jp)
    embeds, positions, lens = _inputs(jcfg, 3, 16, [16, 11, 6], seed=kv_heads)
    probe = jgen.generate(jcfg, jp, jnp.asarray(embeds), jnp.asarray(positions), jnp.asarray(lens),
                          eos_id=-1, max_new_tokens=G)
    eos = int(np.asarray(probe["tokens"])[0, 1])
    j, t = _run_both(jcfg, tcfg, jp, tp, embeds, positions, lens, eos)
    np.testing.assert_array_equal(t["tokens"].numpy(), np.asarray(j["tokens"]))
    np.testing.assert_array_equal(t["valid"].numpy(), np.asarray(j["valid"]))
    assert not t["valid"][0, 2:].any()
    for k in ("entropy", "logprob"):
        np.testing.assert_allclose(np_of(t[k]), np_of(j[k]), rtol=1e-4, atol=1e-4, err_msg=k)


def test_serving_numerics_match_jax():
    """W8A8 prefill and the int8 prompt cache switched on on both sides
    (M = 4 x 80 > 256 engages W8A8). The int8 activation and KV rounding
    sees inputs that differ in the last f32 bits, so a value can round
    across a .5 boundary on one side only: entropy within 2e-3; greedy
    tokens still identical on this seed."""
    JQ.set_w8a8(True)
    TQ.set_w8a8(True)
    jgen.set_kv8(True)
    tgen.set_kv8(True)
    jcfg, tcfg = tiny_cfgs(2)
    jp = JQ.quantize_llama_params(jllama.init_params(jcfg, jax.random.PRNGKey(1), jnp.float32))
    embeds, positions, lens = _inputs(jcfg, 4, 80, [80, 64, 33, 70], seed=3)
    j, t = _run_both(jcfg, tcfg, jp, to_torch(jp), embeds, positions, lens, eos_id=-1)
    np.testing.assert_array_equal(t["tokens"].numpy(), np.asarray(j["tokens"]))
    np.testing.assert_allclose(np_of(t["entropy"]), np_of(j["entropy"]), rtol=0, atol=2e-3)


def test_switch_defaults_follow_the_device(monkeypatch):
    monkeypatch.delenv("REVISIONLLM_KV8", raising=False)
    monkeypatch.delenv("REVISIONLLM_W8A8", raising=False)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert not tgen._kv8_enabled(cpu) and tgen._kv8_enabled(cuda)
    assert not TQ._w8a8_enabled(cpu) and TQ._w8a8_enabled(cuda)
    monkeypatch.setenv("REVISIONLLM_KV8", "0")
    assert not tgen._kv8_enabled(cuda)
    tgen.set_kv8(True)
    assert tgen._kv8_enabled(cpu)


def test_entropy_stats_match_jax():
    rng = np.random.default_rng(0)
    ent = rng.uniform(0, 3, size=(5, 7)).astype(np.float32)
    valid = rng.uniform(size=(5, 7)) > 0.3
    valid[0] = False
    valid[1] = [True] + [False] * 6
    want = jgen.entropy_stats_from_steps(jnp.asarray(ent), jnp.asarray(valid))
    got = tgen.entropy_stats_from_steps(torch.from_numpy(ent), torch.from_numpy(valid))
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=1e-6, atol=1e-6)


def test_temperature_sampling_follows_the_softmax():
    """JAX's PRNG cannot be replayed, so sampling is held by distribution
    only: 4000 identical rows sample their first token; each of the five
    likeliest tokens' frequency lies within 5 binomial standard deviations
    of softmax(logits / temperature)."""
    _, tcfg = tiny_cfgs(vocab_size=64)
    tp = tllama.init_params(tcfg, seed=4, dtype=torch.float32, device="cpu")
    B, T, temp = 4000, 4, 3.0
    embeds = torch.from_numpy(np.random.default_rng(4).normal(size=(1, T, tcfg.hidden_size)).astype(np.float32))
    embeds = embeds.expand(B, T, tcfg.hidden_size).contiguous()
    positions = torch.arange(T, dtype=torch.int32).expand(B, T)
    lens = torch.full((B,), T, dtype=torch.int32)
    logits, _ = tllama.prefill_kv(tcfg, tp, embeds[:1], positions[:1], kv_lens=lens[:1])
    probs = torch.softmax(logits[0] / temp, dim=-1).numpy()
    gen = torch.Generator().manual_seed(0)
    out = tgen.generate(tcfg, tp, embeds, positions, lens, eos_id=-1, max_new_tokens=1,
                        temperature=temp, generator=gen)
    counts = np.bincount(out["tokens"][:, 0].numpy(), minlength=probs.size)
    for tok in np.argsort(probs)[-5:]:
        sd = np.sqrt(B * probs[tok] * (1 - probs[tok]))
        assert abs(counts[tok] - B * probs[tok]) <= 5 * sd, (tok, counts[tok], B * probs[tok])
