"""Port parity for the train CLI's loader branches
(revisionllm_tpu_torch/train/train_cli.py: --model_base, --quant_base,
--pretrain_clip_adapter / --pretrain_mm_mlp_adapter, --stage2_path, and the
dataset's tokenizer) against what the JAX package's train_cli.main
assembles, for the three invocations of the synthetic learning demo
(scripts/synthetic_learning_demo.py:62-113), dense and with --quant_base,
on a tiny HF checkpoint and stage directories from JAX's exporter, on the
CPU. JAX's side is captured by wrapping its trainer's build_trainable,
sharding.shard_params and make_sharded_train_step (the last stops the run
before a step). int8 values and scales equal to the bit; every other leaf
within 1e-6. A vision adapter drawn at random (no --pretrain_* flag) is
held by its tree and shapes only: torch's generator cannot replay JAX's
PRNG."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from revisionllm_tpu.config import AdapterConfig as JAdapter
from revisionllm_tpu.config import LoraConfig as JLora
from revisionllm_tpu.data import synthetic as jsynth
from revisionllm_tpu.models import revisionllm as jrl
from revisionllm_tpu.parallel import sharding as jshard
from revisionllm_tpu.train import checkpoint as jckpt
from revisionllm_tpu.train import train_cli as jcli
from revisionllm_tpu.train import trainer as jtrainer
from revisionllm_tpu_torch.train import train_cli as tcli
from revisionllm_tpu_torch.train import trainer as ttrainer

pytest.importorskip("transformers")
torch.set_num_threads(2)


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A tiny HF checkpoint (hidden 64, 2 layers), a synthetic corpus, a
    stage-1 directory (LoRA r 32 on every linear, the mlp projector) and a
    sparse stage's ClipEncoder (temporal T2V, d 16), random from seeds."""
    root = tmp_path_factory.mktemp("loader")
    hf = jsynth.build_tiny_hf_checkpoint(str(root / "hf"), hidden_size=64, num_layers=2,
                                         num_heads=4, intermediate_size=128)
    corpus = jsynth.make_synthetic_corpus(str(root / "corpus"), n_train_movies=2,
                                          n_val_movies=1, n_classes=2, duration=200.0, seed=5)
    rng = np.random.default_rng(7)
    dims = {"q_proj": (64, 64), "k_proj": (64, 64), "v_proj": (64, 64), "o_proj": (64, 64),
            "gate_proj": (64, 128), "up_proj": (64, 128), "down_proj": (128, 64)}
    lora = {"layers": {n: {"a": rng.normal(size=(2, i, 32)).astype(np.float32) * 0.05,
                           "b": rng.normal(size=(2, 32, o)).astype(np.float32) * 0.05}
                       for n, (i, o) in dims.items()}}
    mlp = jrl.init_vision_params(JAdapter(kind="mlp", hidden_size=64), jax.random.PRNGKey(3),
                                 d_in=16)
    jckpt.export_reference_artifacts(str(root / "s1"), lora,
                                     JLora(r=32, alpha=64, target_patterns=tuple(dims)), mlp)
    clip = JAdapter(kind="clip_encoder", d_model=16, num_heads=4, num_layers=2, ffn_dim=32,
                    hidden_size=64, hierarchy=False, feature_mode="temporal",
                    clip_adapter_text=True)
    jckpt.export_reference_artifacts(
        str(root / "sparse"), None, None,
        jrl.init_vision_params(clip, jax.random.PRNGKey(4), d_in=16))
    return {"root": root, "hf": hf, "corpus": corpus}


def invocation(world, name, out):
    """The demo's argv for stage `name` (1 step), writing to `out`."""
    c, r = world["corpus"], world["root"]
    common = ["--model_base", world["hf"], "--data_path", c["train_json"],
              "--feat_folder", c["features"], "--output_dir", str(out), "--max_steps", "1",
              "--save_steps", "1", "--log_steps", "1"]
    if name == "synthetic_tiny":
        return ["--preset", name] + common
    common += ["--stage2_path", str(r / "s1"), "--q_feat_dir", c["queries"]]
    if name == "synthetic_tiny_sparse":
        return ["--preset", name] + common
    return ["--preset", name] + common + [
        "--pretrain_clip_adapter", str(r / "sparse" / "non_lora_trainables.bin")]


def jax_assembly(argv, monkeypatch):
    """What JAX's train_cli.main assembles for `argv`, up to its first step."""
    got = {}
    build = jtrainer.build_trainable
    shard = jshard.shard_params

    def build_spy(llama_cfg, train_cfg, vision, key, prior_lora=None):
        got.update(vision=vision, prior=prior_lora)
        return build(llama_cfg, train_cfg, vision, key, prior_lora)

    def shard_spy(mesh, tree, specs):
        got.setdefault("base", tree)
        return shard(mesh, tree, specs)

    def step_spy(llama_cfg, adapter_cfg, *a, **k):
        got.update(llama_cfg=llama_cfg, adapter_cfg=adapter_cfg)
        raise _Stop

    monkeypatch.setattr(jtrainer, "build_trainable", build_spy)
    monkeypatch.setattr(jshard, "shard_params", shard_spy)
    monkeypatch.setattr(jtrainer, "make_sharded_train_step", step_spy)
    with pytest.raises(_Stop):
        jcli.main(argv)
    return got


def port_assembly(argv, monkeypatch):
    """The port's Run for `argv`, up to its first step."""
    got = {}
    assemble = tcli.assemble

    def assemble_spy(*a, **k):
        got["run"] = assemble(*a, **k)
        return got["run"]

    def step_spy(*a, **k):
        raise _Stop

    monkeypatch.setattr(tcli, "assemble", assemble_spy)
    monkeypatch.setattr(ttrainer, "make_train_step", step_spy)
    with pytest.raises(_Stop):
        tcli.main(argv + ["--device", "cpu"])
    return got["run"]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for n, t in tree.items() for k, v in _flat(t, f"{prefix}/{n}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree) for k, v in _flat(t, f"{prefix}/{i}").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach()}
    return {prefix: torch.from_numpy(np.array(jax.device_get(tree)).astype(
        np.int8 if np.asarray(tree).dtype == np.int8 else np.float32))}


def assert_trees_match(got, want, what):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w), what
    for k, wv in w.items():
        gv = g[k]
        assert gv.shape == wv.shape, (what, k)
        if wv.dtype == torch.int8 or k.endswith("/scale"):
            assert gv.dtype == wv.dtype and torch.equal(gv, wv), (what, k)
        else:
            torch.testing.assert_close(gv.float(), wv, rtol=1e-6, atol=1e-6, msg=f"{what} {k}")


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "quant_base"])
@pytest.mark.parametrize("name", ["synthetic_tiny", "synthetic_tiny_sparse",
                                  "synthetic_tiny_stage2"])
def test_assembly_matches_jax(world, tmp_path, monkeypatch, name, quant):
    argv = invocation(world, name, tmp_path / "out") + (["--quant_base"] if quant else [])
    want = jax_assembly(argv, monkeypatch)
    run = port_assembly(argv, monkeypatch)
    assert dataclasses.asdict(run.llama_cfg) == dataclasses.asdict(want["llama_cfg"])
    assert dataclasses.asdict(run.adapter_cfg) == dataclasses.asdict(want["adapter_cfg"])
    assert run.llama_cfg.hidden_size == 64 and run.adapter_cfg.hidden_size == 64
    assert_trees_match(run.base, want["base"], "base")
    if quant:
        assert set(run.base["layers"]["q_proj"]) == {"q8", "scale"}
        assert isinstance(run.base["lm_head"], torch.Tensor)
    vision = run.trainable.get("vision", run.frozen.get("vision"))
    if "--pretrain_clip_adapter" in argv:
        assert_trees_match(vision, want["vision"], "vision")
    else:  # a random init from seed + 1: torch's generator cannot replay JAX's PRNG
        g, w = _flat(vision), _flat(want["vision"])
        assert {k: v.shape for k, v in g.items()} == {k: v.shape for k, v in w.items()}
    # the sparse stage keeps the stage-1 LoRA frozen; stage 3 merged it
    if name == "synthetic_tiny_sparse":
        assert_trees_match(run.frozen["lora"], want["prior"], "prior LoRA")
    else:
        assert want["prior"] is None and "lora" not in run.frozen
    # the dataset reads with the checkpoint's tokenizer, not the FakeTokenizer
    assert type(run.dataset.tokenizer).__name__ != "FakeTokenizer"
    assert run.dataset.tokenizer("a b").input_ids == \
        __import__("transformers").AutoTokenizer.from_pretrained(world["hf"])("a b").input_ids


def test_tokenizer_argument_replaces_autotokenizer(world, tmp_path, monkeypatch):
    """main(tokenizer=...) hands that tokenizer to the dataset and never
    calls AutoTokenizer (the GPU's machine has no transformers)."""
    import transformers

    from revisionllm_tpu_torch.utils.testing import FakeTokenizer

    def refuse(*a, **k):
        raise AssertionError("AutoTokenizer called")

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained", refuse)
    tok = FakeTokenizer()
    got = {}
    assemble = tcli.assemble
    monkeypatch.setattr(tcli, "assemble", lambda *a, **k: got.setdefault("run", assemble(*a, **k)))
    run, _ = tcli.main(invocation(world, "synthetic_tiny", tmp_path / "out") + ["--device", "cpu"],
                       tokenizer=tok)
    assert run.dataset.tokenizer is tok and got["run"] is run
    assert os.path.isfile(tmp_path / "out" / "adapter_model.bin")
