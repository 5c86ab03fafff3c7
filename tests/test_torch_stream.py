"""Port parity: the streaming-memory training path (data/stream.py,
synthetic.make_stream_corpus, trainer.make_stream_loss_fn and the train
CLI's stream branch) against revisionllm_tpu on the CPU, from one seed.

The memory builders draw from a numpy Generator in JAX's order, so their
outputs are held bit for bit. The loss runs a tiny f32 Llama with an int8
base, the mlp projector (the stream presets' adapter) and a LoRA whose B is
perturbed away from 0, inside the exact trace on both sides: the loss within
1e-5 relative, each trainable leaf's gradient within 1e-4 relative L2."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revisionllm_tpu.config import AdapterConfig as JA
from revisionllm_tpu.config import LoraConfig as JL
from revisionllm_tpu.config import TrainConfig as JT
from revisionllm_tpu.constants import IMAGE_TOKEN_INDEX, MEMORY_TOKEN_INDEX
from revisionllm_tpu.data import stream as jstream
from revisionllm_tpu.data import synthetic as jsynth
from revisionllm_tpu.models import llama as jllama
from revisionllm_tpu.models import lora as jlora
from revisionllm_tpu.models import revisionllm as jrev
from revisionllm_tpu.models.multimodal import build_splice_plan, stack_plans
from revisionllm_tpu.ops import quant as JQ
from revisionllm_tpu.train import train_cli as jcli
from revisionllm_tpu.train import trainer as jtrainer
from revisionllm_tpu.utils.testing import FakeTokenizer as JTok
from revisionllm_tpu_torch.config import AdapterConfig as TA
from revisionllm_tpu_torch.config import LoraConfig as TLo
from revisionllm_tpu_torch.config import TrainConfig as TT
from revisionllm_tpu_torch.data import stream as tstream
from revisionllm_tpu_torch.data import synthetic as tsynth
from revisionllm_tpu_torch.models.multimodal import KIND_MEMORY
from revisionllm_tpu_torch.train import train_cli as tcli
from revisionllm_tpu_torch.train import trainer as ttrainer
from revisionllm_tpu_torch.utils.testing import FakeTokenizer as TTok

from torch_parity import np_of, tiny_cfgs, to_torch

torch.set_num_threads(2)

MEMORY_TYPES = ("mean_pool", "gt_mean_pool", "gt_multi", "multi_pool")
B, T, D_IN = 4, 60, 16
LOSS_RTOL, GRAD_REL_L2 = 1e-5, 1e-4


def _memory_inputs():
    rng = np.random.default_rng(7)
    images = rng.normal(size=(B, T, D_IN)).astype(np.float32)
    sef = np.array([[3, 20], [0, 59], [40, 41], [10, 30]], np.int32)
    neg = np.array([0, 1, 0, 1], np.int32)   # 0 = negative: a random window
    return images, sef, neg


@pytest.mark.parametrize("memory_type", MEMORY_TYPES)
def test_visual_memory_matches_jax(memory_type):
    """Bit for bit, positive and negative rows, and the rng left in the same
    state (the next draw equal)."""
    images, sef, neg = _memory_inputs()
    jr, tr = np.random.default_rng(3), np.random.default_rng(3)
    want = jstream.build_visual_memory(images, sef, neg, memory_type, jr)
    got = tstream.build_visual_memory(images, sef, neg, memory_type, tr)
    m = 5 if memory_type in ("gt_multi", "multi_pool") else 1
    assert got.shape == (B, m, D_IN) and got.dtype == want.dtype
    assert np.array_equal(got, want)
    assert tr.integers(1 << 30) == jr.integers(1 << 30)
    with pytest.raises(ValueError, match="unknown memory_type"):
        tstream.build_visual_memory(images, sef, neg, "max_pool", tr)


def test_prefix_ids_match_jax():
    neg = np.array([0, 1, 1, 0], np.int32)
    for max_len in (8, 24):
        want = jstream.build_prefix_ids(neg, JTok(), max_len)
        got = tstream.build_prefix_ids(neg, TTok(), max_len)
        assert got.dtype == np.int32 and np.array_equal(got, want)
    assert not np.array_equal(got[0], got[1])


def test_stream_corpus_matches_jax(tmp_path):
    """The same files from the same seed: every feature track, train.json
    and stream_eval.json."""
    kw = dict(n_train_movies=3, n_val_movies=2, duration=200.0, seed=5)
    want = jsynth.make_stream_corpus(str(tmp_path / "jax"), **kw)
    got = tsynth.make_stream_corpus(str(tmp_path / "port"), **kw)
    assert set(got) == set(want) == {"features", "train_json", "eval_json"}
    names = sorted(os.listdir(want["features"]))
    assert sorted(os.listdir(got["features"])) == names and len(names) == 5
    for n in names:
        a, b = np.load(os.path.join(got["features"], n)), np.load(os.path.join(want["features"], n))
        assert a.dtype == b.dtype and np.array_equal(a, b), n
    for key in ("train_json", "eval_json"):
        with open(got[key]) as f, open(want[key]) as g:
            assert json.load(f) == json.load(g), key


# ------------------------------------------------------------- the loss


@pytest.fixture(scope="module")
def stream_setup():
    """Tiny f32 Llama with an int8 base (dense lm_head), the mlp projector,
    a LoRA perturbed away from 0, and one stream batch of two rows: clip 1
    with <video>, clip 2 with <video> and <memory> (a 16-token prefix and a
    mean-pooled memory row)."""
    jcfg, tcfg = tiny_cfgs(num_kv_heads=2)
    jqbase = JQ.quantize_llama_params(jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32),
                                      quantize_lm_head=False)
    akw = dict(kind="mlp", d_model=D_IN, hidden_size=jcfg.hidden_size, hierarchy=False)
    jvision = jrev.init_vision_params(JA(**akw), jax.random.PRNGKey(1), d_in=D_IN)
    lcfg = dict(r=4, alpha=8)
    rng = np.random.default_rng(0)
    jlora_tree = jax.tree.map(
        lambda x: x + 0.05 * jnp.asarray(rng.normal(size=x.shape), jnp.float32),
        jlora.init_lora(jcfg, JL(**lcfg), jax.random.PRNGKey(2)))
    V = 12
    images = rng.normal(size=(2, V, D_IN)).astype(np.float32)
    images2 = rng.normal(size=(2, V, D_IN)).astype(np.float32)
    neg = np.array([0, 1], np.int32)
    mem = jstream.build_visual_memory(images, np.array([[1, 4], [2, 9]], np.int32), neg,
                                      "mean_pool", np.random.default_rng(1))
    prefix_ids = jstream.build_prefix_ids(neg, JTok(), max_len=16)
    P, M = prefix_ids.shape[1], mem.shape[1]
    ids1 = [([1, 10, IMAGE_TOKEN_INDEX, 12, 13], [-100] * 3 + [200, 201]),
            ([1, 11, IMAGE_TOKEN_INDEX, 14], [-100] * 3 + [202])]
    ids2 = [([1, 10, IMAGE_TOKEN_INDEX, 11, MEMORY_TOKEN_INDEX, 12, 13], [-100] * 5 + [200, 201]),
            ([1, IMAGE_TOKEN_INDEX, MEMORY_TOKEN_INDEX, 15], [-100] * 3 + [203])]
    plan1 = stack_plans([build_splice_plan(p, V, 24, labels=l) for p, l in ids1])
    plan2 = stack_plans([build_splice_plan(p, V, 48, labels=l, num_memory_tokens=P + M)
                         for p, l in ids2])
    batch = {**plan1, "images": images, **{f"c2_{k}": v for k, v in plan2.items()},
             "c2_images": images2, "visual_memory": mem, "prefix_ids": prefix_ids}
    return dict(jcfg=jcfg, tcfg=tcfg, jqbase=jqbase, jacfg=JA(**akw), tacfg=TA(**akw),
                jvision=jvision, jlora=jlora_tree, lcfg=lcfg, batch=batch)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree) for p, v in _flat(tree[k], f"{path}/{k}").items()}
    return {path: np_of(tree)}


@pytest.mark.parametrize("stream_loss", ["single", "double"])
def test_stream_loss_matches_jax(stream_setup, stream_loss):
    """make_stream_loss_fn and its gradients against jax.value_and_grad of
    JAX's, remat on: 'double' adds clip 1's loss."""
    s = stream_setup
    kw = dict(stream_loss=stream_loss, memory_type="mean_pool", gradient_checkpointing=True)
    jtcfg, ttcfg = JT(lora=JL(**s["lcfg"]), **kw), TT(lora=TLo(**s["lcfg"]), **kw)
    jb = {k: jnp.asarray(v) for k, v in s["batch"].items()}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in s["batch"].items()}
    jtr = {"lora": s["jlora"], "vision": s["jvision"]}
    jloss_fn = jtrainer.make_stream_loss_fn(s["jcfg"], s["jacfg"], jtcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jloss_fn))(jtr, {}, s["jqbase"], jb,
                                                          jax.random.PRNGKey(3))
    ttr = {"lora": to_torch(s["jlora"]), "vision": to_torch(s["jvision"])}
    leaves = ttrainer.tree_leaves(ttr)
    for t in leaves:
        t.requires_grad_(True)
    tloss_fn = ttrainer.make_stream_loss_fn(s["tcfg"], s["tacfg"], ttcfg)
    with ttrainer._dequant_trace():
        tloss = tloss_fn(ttr, {}, to_torch(s["jqbase"]), tb, torch.Generator().manual_seed(3))
        grads = torch.autograd.grad(tloss, leaves)
    it = iter(grads)
    tgrads = jax.tree.map(lambda _: next(it), ttr, is_leaf=lambda x: isinstance(x, torch.Tensor))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=LOSS_RTOL)
    g, w = _flat(tgrads), _flat(jgrads)
    assert set(g) == set(w) and any(k.startswith("/vision") for k in w)
    for k in w:
        ref = np.linalg.norm(w[k])
        assert ref > 0, k
        assert np.linalg.norm(g[k] - w[k]) <= GRAD_REL_L2 * ref, k
    if stream_loss == "double":
        single = ttrainer.make_stream_loss_fn(s["tcfg"], s["tacfg"], TT(lora=TLo(**s["lcfg"])))
        with ttrainer._dequant_trace(), torch.no_grad():
            assert tloss.item() > single(ttr, {}, to_torch(s["jqbase"]), tb, None).item()


# ------------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def stream_corpus(tmp_path_factory):
    return tsynth.make_stream_corpus(str(tmp_path_factory.mktemp("stream")), n_train_movies=3,
                                     n_val_movies=1, duration=270.0, seed=3)


def _cli_argv(c, out, steps=2, extra=()):
    return ["--preset", "synthetic_tiny_stream", "--data_path", c["train_json"],
            "--feat_folder", c["features"], "--output_dir", out, "--tiny_model",
            "--max_steps", str(steps), "--save_steps", str(steps), "--log_steps", "1",
            "--per_device_batch_size", "2", *extra]


def test_stream_batch_matches_jax(stream_corpus, tmp_path, monkeypatch):
    """The train CLI's stream batches for the synthetic_tiny_stream preset:
    every key (clip 1's plan, each c2_* key, visual_memory, prefix_ids)
    equal to the batches JAX's train_cli hands its step function, for two
    steps (JAX's step replaced by one that records the batch; nothing in the
    JAX package changes)."""
    seen = []

    def recording_step(*a, **k):
        def step(trainable, frozen, base, opt_state, batch, rng):
            seen.append(jax.tree.map(np.asarray, batch))
            return trainable, opt_state, {"loss": jnp.float32(1.0), "grad_norm": jnp.float32(1.0)}
        return step

    monkeypatch.setattr(jtrainer, "make_sharded_train_step", recording_step)
    jcli.main(_cli_argv(stream_corpus, str(tmp_path / "jax")))
    got = []
    tcli.main(_cli_argv(stream_corpus, str(tmp_path / "port"), extra=("--device", "cpu")),
              on_step=lambda step, batch, m: got.append({k: v.numpy() for k, v in batch.items()}))
    assert len(got) == len(seen) == 2
    for g, w in zip(got, seen):
        assert set(g) == set(w)
        assert {"visual_memory", "prefix_ids", "c2_images", "c2_text_ids", "c2_kind",
                "c2_labels"} <= set(g)
        for k in w:
            assert g[k].shape == w[k].shape and np.array_equal(g[k], w[k]), k


@pytest.mark.parametrize("memory_type", [None, "gt_multi"], ids=["preset", "gt_multi"])
def test_train_cli_stream_runs_to_export(stream_corpus, tmp_path, memory_type):
    """train_cli.main on synthetic_tiny_stream --device cpu: finite losses,
    the reference-format export; --memory_type gt_multi gives 5 memory rows
    and 24 + 5 memory positions in clip 2's plan."""
    out = str(tmp_path / "out")
    extra = ["--device", "cpu"] + (["--memory_type", memory_type] if memory_type else [])
    batches, losses = [], []

    def on_step(step, batch, m):
        batches.append(batch)
        losses.append(float(m["loss"]))

    run, _ = tcli.main(_cli_argv(stream_corpus, out, extra=extra), on_step=on_step)
    assert run.train_cfg.memory_type == (memory_type or "gt_mean_pool")
    assert np.isfinite(losses).all() and len(losses) == 2
    m = 5 if memory_type == "gt_multi" else 1
    for b in batches:
        assert b["visual_memory"].shape == (2, m, run.adapter_cfg.d_model)
        assert b["prefix_ids"].shape == (2, tcli.PREFIX_LEN)
        assert ((b["c2_kind"] == KIND_MEMORY).sum(1) == tcli.PREFIX_LEN + m).all()
    assert {"adapter_config.json", "adapter_model.bin",
            "non_lora_trainables.bin"} <= set(os.listdir(out))
