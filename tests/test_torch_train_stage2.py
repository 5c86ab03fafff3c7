"""Port parity: the sparse and stage-2 train steps of the synthetic demo's
recipes against revisionllm_tpu on the CPU, at tiny size in f32.

JAX's train_cli runs one step of `synthetic_tiny_sparse` (the ClipEncoder in
temporal mode, trained alone over a frozen prior LoRA) and of
`synthetic_tiny_stage2` (hierarchy CLS batches, training_stage 3: the prior
LoRA merged into the base, a fresh LoRA trained with the adapter), with its
step function replaced by one that records what it is given. The port's
train_cli must build the same batch from the same flags; then both
packages' losses and gradients are taken on JAX's recorded trees and batch
(the trainable leaves perturbed by the same noise, so that every leaf has a
gradient: a fresh LoRA's B and the stage-2 projector start at zero). The
loss within 1e-5 relative, each trainable leaf's gradient within 1e-4
relative L2; the attention key bias has no gradient in exact arithmetic, so
its error is measured against its layer's query-bias gradient."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revisionllm_tpu.config import LlamaConfig as JLl
from revisionllm_tpu.config import LoraConfig as JL
from revisionllm_tpu.data import synthetic as jsynth
from revisionllm_tpu.models import lora as jlora
from revisionllm_tpu.train import checkpoint as jckpt
from revisionllm_tpu.train import train_cli as jcli
from revisionllm_tpu.train import trainer as jtrainer
from revisionllm_tpu_torch.train import train_cli as tcli
from revisionllm_tpu_torch.train import trainer as ttrainer

from torch_parity import np_of, to_torch

torch.set_num_threads(2)
LOSS_RTOL, GRAD_REL_L2 = 1e-5, 1e-4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The synthetic corpus and a stage-1 PEFT LoRA export at the tiny
    model's geometry (B perturbed away from 0), written by JAX's exporter."""
    root = tmp_path_factory.mktemp("stage2")
    corpus = jsynth.make_synthetic_corpus(str(root / "corpus"), n_train_movies=2,
                                          n_val_movies=1, duration=270.0, seed=3)
    cfg = JLl(**{**JLl.tiny().__dict__, "dtype": "float32"})
    lcfg = JL(r=32, alpha=64, dropout=0.0)
    rng = np.random.default_rng(1)
    prior = jax.tree.map(lambda x: x + 0.02 * jnp.asarray(rng.normal(size=x.shape), jnp.float32),
                         jlora.init_lora(cfg, lcfg, jax.random.PRNGKey(4)))
    jckpt.export_reference_artifacts(str(root / "s1"), prior, lcfg)
    return {"corpus": corpus, "s1": str(root / "s1"), "root": root}


def _argv(w, preset, out):
    c = w["corpus"]
    return ["--preset", preset, "--tiny_model", "--data_path", c["train_json"],
            "--feat_folder", c["features"], "--q_feat_dir", c["queries"],
            "--stage2_path", w["s1"], "--output_dir", out, "--max_steps", "1",
            "--save_steps", "1", "--log_steps", "1"]


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree) for p, v in _flat(tree[k], f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree) for p, v in _flat(x, f"{path}/{i}").items()}
    return {path: np_of(tree)}


@pytest.mark.parametrize("preset", ["synthetic_tiny_sparse", "synthetic_tiny_stage2"])
def test_train_step_matches_jax(world, tmp_path, monkeypatch, preset):
    seen = []

    def recording_step(*a, **k):
        def step(trainable, frozen, base, opt_state, batch, rng):
            seen.append((trainable, frozen, base, batch))
            return trainable, opt_state, {"loss": jnp.float32(1.0), "grad_norm": jnp.float32(1.0)}
        return step

    monkeypatch.setattr(jtrainer, "make_sharded_train_step", recording_step)
    argv = _argv(world, preset, str(tmp_path / "jax"))
    jcli.main(argv)
    jtr, jfrozen, jbase, jbatch = seen[0]

    # the port's CLI assembles the same configs and the same batch
    targv = _argv(world, preset, str(tmp_path / "port")) + ["--device", "cpu"]
    jcfgs = jcli.build_configs(jcli.parse_args(argv))
    tcfgs = tcli.build_configs(tcli.parse_args(targv))
    for j, t in zip(jcfgs[:2], tcfgs[:2]):
        assert t.__dict__ == j.__dict__
    got = []
    run, _ = tcli.main(targv, on_step=lambda s, b, m: got.append(b))
    assert set(got[0]) == set(jbatch)
    for k, v in jbatch.items():
        assert np.array_equal(got[0][k].numpy(), np.asarray(v)), k
    assert set(run.trainable) == set(jtr) and set(run.frozen) == set(jfrozen)
    if preset == "synthetic_tiny_stage2":
        assert jbatch["images"].ndim == 4 and run.frozen == {}   # hierarchy, LoRA merged
    else:
        assert set(jtr) == {"vision"} and "lora" in jfrozen      # adapter over frozen LoRA

    # loss and gradients on JAX's recorded trees and batch
    rng = np.random.default_rng(5)
    jtr = jax.tree.map(lambda x: x + 0.05 * jnp.asarray(rng.normal(size=x.shape), x.dtype), jtr)
    jcfg, jacfg, _, jtcfg = jcfgs
    tcfg, tacfg, _, ttcfg = tcfgs
    jloss, jgrads = jax.jit(jax.value_and_grad(jtrainer.make_loss_fn(jcfg, jacfg, jtcfg)))(
        jtr, jfrozen, jbase, jbatch, jax.random.PRNGKey(0))
    ttr = to_torch(jtr)
    leaves = ttrainer.tree_leaves(ttr)
    for t in leaves:
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    loss_fn = ttrainer.make_loss_fn(tcfg, tacfg, ttcfg)
    with ttrainer._dequant_trace():
        tloss = loss_fn(ttr, to_torch(jfrozen), to_torch(jbase), tb, torch.Generator())
        grads = torch.autograd.grad(tloss, leaves, allow_unused=True)
    it = iter(grads)
    tgrads = jax.tree.map(lambda _: next(it), ttr, is_leaf=lambda x: isinstance(x, torch.Tensor))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=LOSS_RTOL)
    g, w = _flat(tgrads), _flat(jgrads)
    assert set(g) == set(w) and len(w) > 10
    for k in w:
        ref = w[k[: -len("wk/b")] + "wq/b"] if k.endswith("/wk/b") else w[k]
        assert np.linalg.norm(ref) > 0, k
        assert np.linalg.norm(g[k] - w[k]) <= GRAD_REL_L2 * np.linalg.norm(ref), k
    assert os.path.isfile(os.path.join(tmp_path, "port", "non_lora_trainables.bin"))
