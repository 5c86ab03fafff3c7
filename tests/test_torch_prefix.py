"""Port parity: the P-tuning prefix (models/prefix.py) and its paths through
models/llama.py and models/generation.py, against revisionllm_tpu on the
CPU, at tiny size in f32 on the ChatGLM2 geometry with nonzero q/k/v biases
(tolerance 1e-5 unless stated): `prefix_kv` with and without its
projection, the forward with a prefix (serving, and training: gradients
into the prefix table), `prefill_kv(prefix_kv=)` with the prefix folded into
a plain and an int8 cache, `decode_step_split` over it (mask_lens =
prompt_lens + P, rope on prompt_lens), `generate(prefix_kv=)` tokens and
entropies, and the refusals (a shared-prefix prefill of several rows, the
serve slab)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revisionllm_tpu.models import generation as jgen
from revisionllm_tpu.models import llama as jllama
from revisionllm_tpu.models import prefix as jprefix
from revisionllm_tpu_torch.models import generation as tgen
from revisionllm_tpu_torch.models import llama as tllama
from revisionllm_tpu_torch.models import prefix as tprefix

from test_torch_glm import glm_cfgs, glm_params
from torch_parity import np_of, to_torch

torch.set_num_threads(2)
TOL = 1e-5
B, T, P = 3, 9, 6
LENS = np.asarray([9, 7, 4], np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = glm_cfgs()
    jp = glm_params(jcfg, seed=11)
    pp = {"embed": jprefix.init_prefix_params(jcfg, P, jax.random.PRNGKey(1))["embed"] * 10.0}
    rng = np.random.default_rng(12)
    embeds = (rng.normal(size=(B, T + 1, jcfg.hidden_size)) * 0.5).astype(np.float32)
    positions = np.broadcast_to(np.arange(T + 1, dtype=np.int32), (B, T + 1)).copy()
    return jcfg, tcfg, jp, to_torch(jp), pp, embeds, positions


# ------------------------------------------------------------ the module


@pytest.mark.parametrize("projection", [False, True], ids=["table", "projected"])
def test_prefix_kv_matches_jax(projection):
    jcfg, tcfg = glm_cfgs()
    pp = jprefix.init_prefix_params(jcfg, 5, jax.random.PRNGKey(2),
                                    prefix_projection=projection)
    if projection:
        rng = np.random.default_rng(3)
        pp["proj"] = jax.tree.map(lambda x: x + jnp.asarray(0.05 * rng.normal(size=x.shape),
                                                            jnp.float32), pp["proj"])
    want = jprefix.prefix_kv(jcfg, pp)
    got = tprefix.prefix_kv(tcfg, to_torch(pp))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (2, 1, 5, 2, 16) and g.is_contiguous()
        _close(g, w)


def test_init_and_dropout():
    """init_prefix_params draws JAX's tree (names, shapes; 0.02 normals,
    zero biases); dropout applies only with a generator, keeping 1 - rate
    of the values, scaled by 1 / (1 - rate)."""
    jcfg, tcfg = glm_cfgs()
    gen = torch.Generator().manual_seed(0)
    got = tprefix.init_prefix_params(tcfg, 40, gen, prefix_projection=True, device="cpu")
    want = jprefix.init_prefix_params(jcfg, 40, jax.random.PRNGKey(0), prefix_projection=True)
    shapes = jax.tree.map(lambda x: tuple(x.shape), want)
    assert jax.tree.map(lambda t: tuple(t.shape), got,
                        is_leaf=lambda x: isinstance(x, torch.Tensor)) == shapes
    assert abs(got["embed"].std().item() - 0.02) < 2e-3 and not got["proj"]["b1"].any()
    pk0, _ = tprefix.prefix_kv(tcfg, got)
    pk1, _ = tprefix.prefix_kv(tcfg, got, dropout_rate=0.5)
    torch.testing.assert_close(pk0, pk1, rtol=0, atol=0)
    pk2, _ = tprefix.prefix_kv(tcfg, got, dropout_rate=0.5,
                               generator=torch.Generator().manual_seed(1))
    kept = pk2 != 0
    assert 0.4 < kept.float().mean().item() < 0.6
    torch.testing.assert_close(pk2[kept], 2.0 * pk0[kept])


# ------------------------------------------------------- the backbone paths


@pytest.mark.parametrize("trainable", [False, True], ids=["serving", "trainable"])
def test_forward_with_prefix_matches_jax(world, trainable):
    """Serving: row 6's plain version; trainable: the lse pieces and their
    merge under autograd, as JAX's use_pallas=False forward."""
    jcfg, tcfg, jp, tp, pp, embeds, positions = world
    jpkv = jprefix.prefix_kv(jcfg, pp)
    want = jllama.forward_hidden(jcfg, jp, jnp.asarray(embeds), jnp.asarray(positions),
                                 kv_lens=jnp.asarray(LENS + 1), prefix_kv=jpkv,
                                 trainable=trainable)
    got = tllama.forward_hidden(tcfg, tp, torch.from_numpy(embeds), torch.from_numpy(positions),
                                kv_lens=torch.from_numpy(LENS + 1),
                                prefix_kv=tprefix.prefix_kv(tcfg, to_torch(pp)),
                                trainable=trainable)
    _close(got, want)
    plain = tllama.forward_hidden(tcfg, tp, torch.from_numpy(embeds), torch.from_numpy(positions),
                                  kv_lens=torch.from_numpy(LENS + 1))
    assert (got - plain).abs().max() > 1e-2   # the prefix matters


@pytest.mark.parametrize("remat", [False, True])
def test_ptuning_gradients_match_jax(world, remat):
    """P-tuning trains the prefix table alone: the gradient of a loss on the
    hidden states (a fixed random projection of them: the sum of their
    squares is nearly constant after the final RMSNorm) reaches it, through
    the projection too, within 1e-4 relative L2 of JAX's (remat recomputes
    each layer in the backward)."""
    jcfg, tcfg, jp, tp, pp, embeds, positions = world
    pp = dict(pp)
    rng = np.random.default_rng(4)
    proj = jprefix.init_prefix_params(jcfg, P, jax.random.PRNGKey(4),
                                      prefix_projection=True)["proj"]
    # weights of unit-order gain, so the prefix's values (and gradients)
    # are not rounding noise
    pp["proj"] = {k: jnp.asarray(rng.normal(size=v.shape) * (v.shape[0] ** -0.5 if v.ndim == 2
                                                             else 0.1), jnp.float32)
                  for k, v in proj.items()}

    r = rng.normal(size=embeds.shape).astype(np.float32)

    def jloss(q):
        h = jllama.forward_hidden(jcfg, jp, jnp.asarray(embeds), jnp.asarray(positions),
                                  prefix_kv=jprefix.prefix_kv(jcfg, q), trainable=True,
                                  remat=remat)
        return jnp.sum(h * r)

    want = jax.grad(jloss)(pp)
    tq = to_torch(pp)
    leaves = [tq["embed"], tq["proj"]["w1"], tq["proj"]["w2"]]
    for t in leaves:
        t.requires_grad_(True)
    h = tllama.forward_hidden(tcfg, tp, torch.from_numpy(embeds), torch.from_numpy(positions),
                              prefix_kv=tprefix.prefix_kv(tcfg, tq), trainable=True, remat=remat)
    got = torch.autograd.grad((h * torch.from_numpy(r)).sum(), leaves)
    for g, w in zip(got, (want["embed"], want["proj"]["w1"], want["proj"]["w2"])):
        w = np.asarray(w)
        assert np.linalg.norm(w) > 0
        assert np.linalg.norm(np_of(g) - w) <= 1e-4 * np.linalg.norm(w)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["kv16", "kv8"])
def test_prefill_and_decode_with_prefix_match_jax(world, kv_quant):
    """prefill_kv folds the prefix into the cache at [0, P) (int8 with its
    scales under kv_quant); then decode_step_split over it with mask_lens =
    prompt_lens + P, rope on prompt_lens: logits within 1e-4; the decode
    reproduces the full forward's next-position logits."""
    jcfg, tcfg, jp, tp, pp, embeds, positions = world
    jpkv = jprefix.prefix_kv(jcfg, pp)
    tpkv = tprefix.prefix_kv(tcfg, to_torch(pp))
    e, pos = embeds[:, :T], positions[:, :T]
    jl, jc = jllama.prefill_kv(jcfg, jp, jnp.asarray(e), jnp.asarray(pos),
                               kv_lens=jnp.asarray(LENS), kv_quant=kv_quant, prefix_kv=jpkv)
    tl, tc = tllama.prefill_kv(tcfg, tp, torch.from_numpy(e), torch.from_numpy(pos),
                               kv_lens=torch.from_numpy(LENS), kv_quant=kv_quant,
                               prefix_kv=tpkv)
    _close(tl, jl, 1e-4)
    assert set(tc) == set(jc) and tc["k"].shape[2] == P + T
    for name in jc:
        if tc[name].dtype == torch.int8:
            diff = np.abs(tc[name].numpy().astype(np.int32) - np.asarray(jc[name], np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 5e-3, name
        else:
            _close(tc[name], jc[name], 1e-4)
    tc = to_torch(jc)
    jg = {n: jnp.zeros((2, B, 3, 2, 16), jnp.float32) for n in ("k", "v")}
    tg = tllama.init_gen_cache(tcfg, B, 3, torch.float32, "cpu")
    tok = embeds[np.arange(B), LENS][:, None]
    jlog, _ = jllama.decode_step_split(jcfg, jp, jc, jnp.asarray(LENS), jg,
                                       jnp.asarray(0, jnp.int32), jnp.asarray(tok),
                                       mask_lens=jnp.asarray(LENS + P))
    tlog, _ = tllama.decode_step_split(tcfg, tp, tc, torch.from_numpy(LENS), tg, 0,
                                       torch.from_numpy(tok), torch.from_numpy(LENS + P))
    _close(tlog, jlog, 1e-4)
    if not kv_quant:  # teacher forcing: the full forward over T + 1 positions
        full = np.array(embeds)
        full[np.arange(B), LENS] = tok[:, 0]
        h = tllama.forward_hidden(tcfg, tp, torch.from_numpy(full), torch.from_numpy(positions),
                                  kv_lens=torch.from_numpy(LENS + 1), prefix_kv=tpkv)
        want = tllama.logits_from_hidden(tp, h[torch.arange(B), torch.from_numpy(LENS).long()])
        _close(tlog, want, 2e-4)


@pytest.mark.parametrize("kv8", [False, True], ids=["kv16", "kv8"])
def test_generate_with_prefix_matches_jax(world, kv8):
    """Greedy tokens equal and entropies within 1e-4 (int8 prompt cache:
    1e-3); the prefix changes what is generated."""
    jcfg, tcfg, jp, tp, pp, embeds, positions = world
    e, pos = embeds[:, :T], positions[:, :T]
    kw = dict(eos_id=2, max_new_tokens=5)
    jgen.set_kv8(kv8)
    try:
        want = jgen.generate(jcfg, jp, jnp.asarray(e), jnp.asarray(pos), jnp.asarray(LENS),
                             prefix_kv=jprefix.prefix_kv(jcfg, pp), **kw)
    finally:
        jgen.set_kv8(None)
    tgen.set_kv8(kv8)
    try:
        tpkv = tprefix.prefix_kv(tcfg, to_torch(pp))
        got = tgen.generate(tcfg, tp, torch.from_numpy(e), torch.from_numpy(pos),
                            torch.from_numpy(LENS), prefix_kv=tpkv, **kw)
        plain = tgen.generate(tcfg, tp, torch.from_numpy(e), torch.from_numpy(pos),
                              torch.from_numpy(LENS), **kw)
    finally:
        tgen.set_kv8(None)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    _close(got["entropy"], want["entropy"], 1e-3 if kv8 else 1e-4)
    assert not torch.equal(got["tokens"], plain["tokens"]) or not torch.allclose(
        got["entropy"], plain["entropy"])


def test_prefix_refusals_match_jax(world):
    """A prefix with a shared-prefix prefill of several rows raises on both
    sides; the serve slab takes no prefix."""
    jcfg, tcfg, jp, tp, pp, embeds, positions = world
    e, pos = embeds[:, :T], positions[:, :T]
    with pytest.raises(ValueError, match="shared-prefix"):
        jgen.generate(jcfg, jp, jnp.asarray(e), jnp.asarray(pos), jnp.asarray(LENS), eos_id=2,
                      max_new_tokens=2, shared_prefix_len=3,
                      prefix_kv=jprefix.prefix_kv(jcfg, pp))
    tpkv = tprefix.prefix_kv(tcfg, to_torch(pp))
    with pytest.raises(ValueError, match="shared-prefix"):
        tgen.generate(tcfg, tp, torch.from_numpy(e), torch.from_numpy(pos),
                      torch.from_numpy(LENS), eos_id=2, max_new_tokens=2, shared_prefix_len=3,
                      prefix_kv=tpkv)
    with pytest.raises(ValueError, match="serve slab"):
        tllama.prefill_kv(tcfg, tp, torch.from_numpy(e), torch.from_numpy(pos),
                          kv_lens=torch.from_numpy(LENS), kv_quant=True, kv_slab_slots=4,
                          prefix_kv=tpkv)
