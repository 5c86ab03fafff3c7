"""Port parity: the adapter's other modes against revisionllm_tpu on the CPU,
at tiny size in f32 (tolerance 1e-5 unless stated).

ops/linear_attention.py (the performer's features and self-attention, the
linformer), models/adapter.py's CrossLayer self-attention variants at both
insertion points, the chapters `cross_attn` adapter (hidden-wide frames;
other widths raise on both sides), the 'alternate' and 'all' outputs,
`encode_video` with `alternate_ln`, the alternate train step's loss and
gradients at both parities, the performer features' zero gradient, and the
export of a cross_attn adapter's `text_proj`. Random features and the
linformer's projection are JAX's, carried across with the rest of the tree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revisionllm_tpu.config import AdapterConfig as JA
from revisionllm_tpu.config import LoraConfig as JLC
from revisionllm_tpu.config import TrainConfig as JTC
from revisionllm_tpu.models import adapter as jad
from revisionllm_tpu.models import llama as jllama
from revisionllm_tpu.models import lora as jlora
from revisionllm_tpu.models import revisionllm as jrl
from revisionllm_tpu.models.multimodal import build_splice_plan, stack_plans
from revisionllm_tpu.ops import linear_attention as jla
from revisionllm_tpu.train import checkpoint as jckpt
from revisionllm_tpu.train import trainer as jtrainer
from revisionllm_tpu_torch.config import AdapterConfig as TA
from revisionllm_tpu_torch.config import LoraConfig as TLC
from revisionllm_tpu_torch.config import TrainConfig as TTC
from revisionllm_tpu_torch.models import adapter as tad
from revisionllm_tpu_torch.models import convert as tconvert
from revisionllm_tpu_torch.models import revisionllm as trl
from revisionllm_tpu_torch.ops import linear_attention as tla
from revisionllm_tpu_torch.train import checkpoint as tckpt
from revisionllm_tpu_torch.train import trainer as ttrainer

from torch_parity import np_of, tiny_cfgs, to_torch

torch.set_num_threads(2)
TOL = 1e-5
D, HID, T, LQ = 16, 24, 10, 5


def _kw(**kw):
    """A narrow ClipEncoder: d 16, 4 heads, 2 layers, FFN 32, the T2V
    encoder on, dropout 0; linformer k 8 over 12 rows."""
    return {**dict(d_model=D, num_heads=4, num_layers=2, ffn_dim=32, hidden_size=HID,
                   clip_adapter_text=True, hierarchy=False, feature_mode="temporal",
                   dropout=0.0, linformer_k=8, max_video_length=12), **kw}


def _cfgs(**kw):
    return JA(**_kw(**kw)), TA(**_kw(**kw))


def _perturbed(tree, seed, scale=0.1):
    """JAX's tree with every leaf moved by seeded noise (norms' biases and
    the projector stop being 0 and 1)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: x + scale * jnp.asarray(rng.normal(size=x.shape), x.dtype), tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=tol, atol=tol)


def _inputs(width, B=3, seed=0):
    rng = np.random.default_rng(seed)
    video = rng.normal(size=(B, T, width)).astype(np.float32)
    text = rng.normal(size=(B, LQ, D)).astype(np.float32)
    valid = np.ones((B, LQ), bool)
    valid[1, 3:] = False
    return video, text, valid


# ------------------------------------------------------ ops/linear_attention


def _sa_layer(kind, seed=1, d=D, heads=4):
    jcfg, _ = _cfgs(ca_self_attn=kind)
    sa = jad._init_ca_self_attn(jcfg, jax.random.PRNGKey(seed), d, jnp.float32)
    return _perturbed({k: v for k, v in sa.items() if k != "features"}, seed) | (
        {"features": sa["features"]} if "features" in sa else {})


@pytest.mark.parametrize("is_query", [True, False], ids=["query", "key"])
def test_performer_features_match_jax(is_query):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 7, 4, 4)).astype(np.float32)
    proj = np.asarray(jla.orthogonal_gaussian(jax.random.PRNGKey(2), 4, 9))
    want = jla.performer_features(jnp.asarray(x), jnp.asarray(proj), is_query)
    got = tla.performer_features(torch.from_numpy(x), torch.from_numpy(proj), is_query)
    assert got.dtype == torch.float32
    _close(got, want)


def test_orthogonal_gaussian_blocks_are_orthogonal():
    """Columns of each dim-wide block are orthogonal, with gaussian norms."""
    gen = torch.Generator().manual_seed(0)
    w = tla.orthogonal_gaussian(gen, 6, 14)
    assert w.shape == (6, 14)
    for lo in (0, 6):
        blk = w[:, lo:lo + 6]
        unit = blk / blk.norm(dim=0, keepdim=True)
        np.testing.assert_allclose((unit.T @ unit).numpy(), np.eye(6), atol=1e-5)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "padded"])
@pytest.mark.parametrize("kind", ["performer", "linformer", "linformer-kv"])
def test_linear_self_attention_matches_jax(kind, masked):
    """performer_self_attention on JAX's features; linformer_self_attention
    with the shared kv head (and with separate wk / wv), its e_proj sliced
    to the live length; a padded row masked out of the kv sums."""
    sa = _sa_layer("performer" if kind == "performer" else "linformer")
    if kind == "linformer-kv":
        rng = np.random.default_rng(9)
        sa = {k: v for k, v in sa.items() if k != "wkv"}
        for n in ("wk", "wv"):
            sa[n] = {"w": jnp.asarray(rng.normal(size=(D, 4)), jnp.float32),
                     "b": jnp.asarray(rng.normal(size=(4,)), jnp.float32)}
    video, _, _ = _inputs(D)
    valid = np.ones(video.shape[:2], bool)
    if masked:
        valid[0, 6:] = False
    v = jnp.asarray(valid) if masked else None
    tv = torch.from_numpy(valid) if masked else None
    tsa = to_torch(sa)
    if kind == "performer":
        want = jla.performer_self_attention(sa, jnp.asarray(video), 4, sa["features"], v)
        got = tla.performer_self_attention(tsa, torch.from_numpy(video), 4, tsa["features"], tv)
    else:
        want = jla.linformer_self_attention(sa, jnp.asarray(video), 4, sa["e_proj"], v)
        got = tla.linformer_self_attention(tsa, torch.from_numpy(video), 4, tsa["e_proj"], tv)
    _close(got, want)


# ------------------------------------------------------- models/adapter.py


def _vision(jcfg, seed=1, width=None):
    return _perturbed(jrl.init_vision_params(jcfg, jax.random.PRNGKey(seed),
                                             d_in=width or jcfg.d_model), seed)


def _forward_both(jcfg, tcfg, vision, video, text, valid, iteration_step=0):
    want = jad.clip_encoder_forward(jcfg, vision["mm_projector"], jnp.asarray(video),
                                    jnp.asarray(text), jnp.asarray(valid), iteration_step)
    tv = to_torch(vision)
    got = tad.clip_encoder_forward(tcfg, tv["mm_projector"], torch.from_numpy(video),
                                   torch.from_numpy(text), torch.from_numpy(valid),
                                   iteration_step=iteration_step)
    return got, want


@pytest.mark.parametrize("sa_pos", [1, 2])
@pytest.mark.parametrize("kind", ["performer", "linformer", "self-attn"])
def test_ca_self_attn_forward_matches_jax(kind, sa_pos):
    jcfg, tcfg = _cfgs(ca_self_attn=kind, sa_pos=sa_pos)
    vision = _vision(jcfg)
    sa = vision["mm_projector"]["t2v_layers"][0]["sa"]
    assert ("features" in sa) == (kind == "performer") and ("wkv" in sa) == (kind == "linformer")
    video, text, valid = _inputs(D)
    got, want = _forward_both(jcfg, tcfg, vision, video, text, valid)
    assert tuple(got.shape) == (3, T, HID)
    _close(got, want)


def test_port_init_has_jax_tree_structure():
    """init_adapter_params draws the same tree (names and shapes) as JAX's
    for each mode; the performer's features stay f32 under a bf16 init."""
    for kw in (dict(ca_self_attn="performer"), dict(ca_self_attn="linformer"),
               dict(ca_self_attn="self-attn", sa_pos=1), dict(cross_attn=True),
               dict(feature_mode="alternate")):
        jcfg, tcfg = _cfgs(**kw)
        want = jax.tree.map(lambda x: (x.shape, str(x.dtype)),
                            jrl.init_vision_params(jcfg, jax.random.PRNGKey(0), d_in=D,
                                                   dtype=jnp.bfloat16))
        got = trl.init_vision_params(tcfg, seed=0, d_in=D, dtype=torch.bfloat16, device="cpu")
        got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), got,
                           is_leaf=lambda x: isinstance(x, torch.Tensor))
        assert got == want, kw


def test_cross_attn_forward_matches_jax_on_hidden_wide_frames():
    """The chapters adapter runs at hidden_size: text_proj maps the
    d_model query to hidden, the projector is the identity."""
    jcfg, tcfg = _cfgs(cross_attn=True, hierarchy=True, feature_mode="cls")
    vision = _vision(jcfg, width=HID)
    assert "text_proj" in vision["mm_projector"] and "mm_projector" not in vision["mm_projector"]
    video, text, valid = _inputs(HID)
    got, want = _forward_both(jcfg, tcfg, vision, video, text, valid)
    assert tuple(got.shape) == (3, 1, HID)
    _close(got, want)


def test_cross_attn_refuses_d_model_wide_frames_on_both_sides():
    """JAX's cross_attn adapter broadcasts its hidden-wide CLS token to the
    frames' width: d_model-wide frames raise there, and in the port."""
    jcfg, tcfg = _cfgs(cross_attn=True, hierarchy=True, feature_mode="cls")
    vision = _vision(jcfg, width=HID)
    video, text, valid = _inputs(D)
    with pytest.raises(ValueError):
        jad.clip_encoder_forward(jcfg, vision["mm_projector"], jnp.asarray(video),
                                 jnp.asarray(text), jnp.asarray(valid))
    with pytest.raises(ValueError, match="width"):
        tad.clip_encoder_forward(tcfg, to_torch(vision)["mm_projector"], torch.from_numpy(video),
                                 torch.from_numpy(text), torch.from_numpy(valid))


@pytest.mark.parametrize("mode,step,tokens", [("alternate", 0, 1), ("alternate", 1, T),
                                              ("alternate", 7, T), ("all", 0, 1 + T)])
def test_alternate_and_all_outputs_match_jax(mode, step, tokens):
    jcfg, tcfg = _cfgs(feature_mode=mode, ca_self_attn="performer")
    vision = _vision(jcfg)
    video, text, valid = _inputs(D)
    got, want = _forward_both(jcfg, tcfg, vision, video, text, valid, iteration_step=step)
    assert tuple(got.shape) == (3, tokens, HID)
    _close(got, want)


@pytest.mark.parametrize("hierarchy", [True, False], ids=["windows", "window"])
@pytest.mark.parametrize("step", [0, 1])
def test_encode_video_applies_alternate_ln(hierarchy, step):
    """'alternate' mode normalises the adapter's output by `alternate_ln`
    (moved off 1 and 0 here); the hierarchy input [B, V, T, d] gives one CLS
    per window on even steps."""
    jcfg, tcfg = _cfgs(feature_mode="alternate", hierarchy=hierarchy, ca_self_attn="linformer")
    vision = _vision(jcfg, seed=4)
    assert "alternate_ln" in vision
    rng = np.random.default_rng(6)
    shape = (2, 3, T, D) if hierarchy and step == 0 else (2, T, D)
    images = rng.normal(size=shape).astype(np.float32)
    qf = rng.normal(size=(2, LQ, D)).astype(np.float32)
    want = jrl.encode_video(jcfg, vision, jnp.asarray(images), jnp.asarray(qf), None, step)
    got = trl.encode_video(tcfg, to_torch(vision), torch.from_numpy(images),
                           torch.from_numpy(qf), iteration_step=step)
    _close(got, want)


# ------------------------------------------------- the alternate train step


def _train_world(kind):
    """Tiny f32 Llama (a LoRA perturbed off zero), the alternate adapter with
    `kind` self-attention, and one batch for each parity: hierarchy CLS
    windows [B, V, T, d] on even steps, a temporal window [B, T, d] on odd
    ones, each with its splice plan and labels."""
    jcfg, tcfg = tiny_cfgs()
    ja, ta = _cfgs(feature_mode="alternate", hierarchy=True, ca_self_attn=kind,
                   hidden_size=jcfg.hidden_size)
    base = jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    lcfg = JLC(r=4, alpha=8, dropout=0.0)
    lora = _perturbed(jlora.init_lora(jcfg, lcfg, jax.random.PRNGKey(3)), 5, 0.02)
    vision = _vision(ja, seed=2)
    rng = np.random.default_rng(8)
    batches = {}
    for parity, n_video in ((0, 4), (1, T)):
        ids = [1, 5, 9, -200, 11, 12, 13, 14]
        labels = [-100] * 5 + [12, 13, 14]
        plan = stack_plans([build_splice_plan(ids, n_video, 24, labels=labels)] * 2)
        shape = (2, 4, T, D) if parity == 0 else (2, T, D)
        batches[parity] = {**plan,
                           "images": rng.normal(size=shape).astype(np.float32),
                           "query_feats": rng.normal(size=(2, LQ, D)).astype(np.float32),
                           "query_valid": np.ones((2, LQ), bool)}
    return (jcfg, tcfg, ja, ta, lcfg), base, {"lora": {"layers": lora["layers"]},
                                               "vision": vision}, batches


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree) for p, v in _flat(tree[k], f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree) for p, v in _flat(x, f"{path}/{i}").items()}
    return {path: np_of(tree)}


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("kind", ["performer", "linformer"])
def test_alternate_train_step_matches_jax(kind, parity):
    """make_loss_fn(..., iteration_step) at each parity: the loss within
    1e-5 relative, each trainable leaf's gradient within 1e-4 relative L2
    (the key bias's against its layer's query-bias gradient, as it has none
    in exact arithmetic; the performer's features get exactly zero on both
    sides; leaves the parity does not reach, zero on both sides)."""
    (jcfg, tcfg, ja, ta, lcfg), base, jtr, batches = _train_world(kind)
    batch = batches[parity]
    jtc = JTC(lora=lcfg, gradient_checkpointing=False)
    ttc = TTC(lora=TLC(**lcfg.__dict__), gradient_checkpointing=False)
    jloss, jgrads = jax.jit(jax.value_and_grad(jtrainer.make_loss_fn(jcfg, ja, jtc, parity)))(
        jtr, {}, base, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    ttr = to_torch(jtr)
    leaves = ttrainer.tree_leaves(ttr)
    for t in leaves:
        t.requires_grad_(True)
    loss_fn = ttrainer.make_loss_fn(tcfg, ta, ttc, parity)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with ttrainer._dequant_trace():
        tloss = loss_fn(ttr, {}, to_torch(base), tb, torch.Generator())
        grads = torch.autograd.grad(tloss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    it = iter(grads)
    tgrads = jax.tree.map(lambda _: next(it), ttr, is_leaf=lambda x: isinstance(x, torch.Tensor))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    g, w = _flat(tgrads), _flat(jgrads)
    assert set(g) == set(w)
    for k in w:
        if k.endswith("/features"):
            assert not g[k].any() and not w[k].any(), k
            continue
        ref = w[k[: -len("wk/b")] + "wq/b"] if k.endswith("/wk/b") else w[k]
        if np.linalg.norm(ref) == 0:
            assert not g[k].any(), k
            continue
        assert np.linalg.norm(g[k] - w[k]) <= 1e-4 * np.linalg.norm(ref), k


def test_performer_features_get_zero_gradient():
    """The features are a fixed buffer: detached at use, so a train step's
    backward leaves them no gradient while their layer's weights get one."""
    jcfg, tcfg = _cfgs(ca_self_attn="performer")
    tv = to_torch(_vision(jcfg))
    adapter = tv["mm_projector"]
    for t in ttrainer.tree_leaves(tv):
        t.requires_grad_(True)
    video, text, valid = _inputs(D)
    out = tad.clip_encoder_forward(tcfg, adapter, torch.from_numpy(video), torch.from_numpy(text),
                                   torch.from_numpy(valid))
    sa = adapter["t2v_layers"][0]["sa"]
    g_feat, g_wq = torch.autograd.grad(out.square().sum(), [sa["features"], sa["wq"]["w"]],
                                       allow_unused=True)
    assert g_feat is None and g_wq.abs().sum() > 0


# ------------------------------------------------------------ the export


def test_cross_attn_export_keeps_text_proj(tmp_path):
    """A trained cross_attn adapter exported by the port keeps
    text_mm_projector.*: read back by convert_clip_adapter, text_proj and
    every other leaf survive; the exported names are JAX's exporter's."""
    jcfg, tcfg = _cfgs(cross_attn=True, hierarchy=True, feature_mode="cls")
    vision = _vision(jcfg, width=HID)
    tckpt.export_reference_artifacts(str(tmp_path / "port"), None, None, vision=to_torch(vision))
    jckpt.export_reference_artifacts(str(tmp_path / "jax"), None, None, vision=vision)
    port = torch.load(tmp_path / "port" / "non_lora_trainables.bin", weights_only=True)
    ref = torch.load(tmp_path / "jax" / "non_lora_trainables.bin", weights_only=True)
    assert sorted(port) == sorted(ref)
    assert "model.mm_projector.text_mm_projector.weight" in port
    back = tconvert.convert_clip_adapter({k: v.float().numpy() for k, v in port.items()}, tcfg)
    assert set(back) == set(vision["mm_projector"])
    want = _flat(vision["mm_projector"])
    got = _flat(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_dataclass_fields_match_jax():
    """The port's AdapterConfig carries every field JAX's does."""
    assert [f.name for f in dataclasses.fields(TA)] == [f.name for f in dataclasses.fields(JA)]
