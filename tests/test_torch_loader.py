"""Port parity for the entry points that start from a checkpoint on disk
(revisionllm_tpu_torch/eval/loader.py build_engine_from_args,
eval/stage1.py main, eval/stage2.py main) against revisionllm_tpu's on the
same directories: a tiny HF Llama with a word-level tokenizer
(data/synthetic.build_tiny_hf_checkpoint: hidden 64, 2 layers, 4 heads) and
stage directories from JAX's exporter (LoRA on q/v, a narrow ClipEncoder
T2V adapter: temporal for stage 1, hierarchy cls for stage 2), on the CPU.

Both packages read the weights as bf16. XLA's and torch's CPU bf16
arithmetic round differently, so the `main` parity tests compute in f32
(both packages' llama_config_from_hf patched to dtype float32): the bf16
weights are then the same numbers on both sides and the JSONL records agree
to rtol 1e-4."""

import dataclasses
import filecmp
import json
import os

import jax
import numpy as np
import pytest
import torch

from revisionllm_tpu.config import AdapterConfig as JAdapter
from revisionllm_tpu.config import LoraConfig as JLora
from revisionllm_tpu.data import synthetic as jsynth
from revisionllm_tpu.eval import loader as jloader
from revisionllm_tpu.eval import stage1 as jstage1
from revisionllm_tpu.eval import stage2 as jstage2
from revisionllm_tpu.models import convert as jconv
from revisionllm_tpu.models import revisionllm as jrl
from revisionllm_tpu.train import checkpoint as jckpt
from revisionllm_tpu_torch.data import synthetic as tsynth
from revisionllm_tpu_torch.eval import loader as tloader
from revisionllm_tpu_torch.eval import stage1 as tstage1
from revisionllm_tpu_torch.eval import stage2 as tstage2
from revisionllm_tpu_torch.models import convert as tconv

from torch_parity import adapter_kw, assert_records_equal, records

pytest.importorskip("transformers")
torch.set_num_threads(2)

ADAPTER_FLAGS = ["--clip_adapter", "True", "--clip_adapter_text", "True",
                 "--adapter_d_model", "16", "--adapter_heads", "4", "--adapter_layers", "2",
                 "--adapter_ffn", "32", "--debug", "True"]
S1_FLAGS = ["--debug_window", "20", "--num_frames", "16", "--feature_fps", "2", "--batch", "4",
            "--max_new_tokens", "6"] + ADAPTER_FLAGS
S2_FLAGS = ["--debug_window", "20", "--num_frames", "16", "--feature_fps", "2", "--batch", "8",
            "--stride", "5", "--zooms", "2,1", "--max_new_tokens", "4",
            "--distributed_retrieval", "1"] + ADAPTER_FLAGS


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The checkpoint, one stage directory per stage, a 200 s movie at 2 fps
    (400 frames of 16-d features) and two queries with their features."""
    root = tmp_path_factory.mktemp("ckpt")
    hf = jsynth.build_tiny_hf_checkpoint(str(root / "hf"), hidden_size=64, num_layers=2,
                                         num_heads=4, intermediate_size=128)
    rng = np.random.default_rng(3)
    lora = {"layers": {n: {"a": rng.normal(size=(2, 64, 4)).astype(np.float32) * 0.1,
                           "b": rng.normal(size=(2, 4, 64)).astype(np.float32) * 0.1}
                       for n in ("q_proj", "v_proj")}}
    stages = {}
    for name, hierarchy in (("s1", False), ("s2", True)):
        vision = jrl.init_vision_params(JAdapter(**adapter_kw(64, hierarchy)),
                                        jax.random.PRNGKey(1), d_in=16)
        stages[name] = str(root / name)
        jckpt.export_reference_artifacts(
            stages[name], lora, JLora(r=4, alpha=8, target_patterns=("q_proj", "v_proj")),
            vision)
    rng = np.random.default_rng(0)
    np.save(root / "m1.npy", rng.normal(size=(400, 16)).astype(np.float32))
    data = {"q1": {"movie": "m1", "movie_duration": 200.0, "timestamps": [50.0, 60.0],
                   "query": "a red car drives by."},
            "q2": {"movie": "m1", "movie_duration": 200.0, "timestamps": [100.0, 110.0],
                   "query": "someone opens a door?"}}
    with open(root / "val.json", "w") as f:
        json.dump(data, f)
    (root / "q").mkdir()
    for qid in data:
        np.savez(root / "q" / f"{qid}.npz",
                 token_features=rng.normal(size=(5, 16)).astype(np.float32),
                 cls_features=rng.normal(size=(16,)).astype(np.float32))
    common = ["--model_base", hf, "--data_path", str(root / "val.json"),
              "--feat_folder", str(root), "--q_feat_dir", str(root / "q")]
    return {"root": root, "hf": hf, "stages": stages, "common": common}


def _argv(ckpt, stage, log=None):
    flags = S1_FLAGS if stage == "s1" else S2_FLAGS
    return ckpt["common"] + ["--stage2", ckpt["stages"][stage], "--log_path",
                             str(log or ckpt["root"] / "unused")] + flags


def _flat(tree, prefix=""):
    """{path: float64 or int array} of a JAX or a port tree."""
    if isinstance(tree, dict):
        return {k: v for n, t in tree.items() for k, v in _flat(t, f"{prefix}/{n}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree) for k, v in _flat(t, f"{prefix}/{i}").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: (tree.dtype, tree.double().numpy())}
    a = np.asarray(tree)
    return {prefix: (a.dtype.name, a.astype(np.float64))}


@pytest.mark.parametrize("env", [{}, {"REVISIONLLM_QUANT": "int8"},
                                 {"REVISIONLLM_QUANT": "int8", "REVISIONLLM_SERVE": "1"}],
                         ids=["cpu_default", "int8", "serve"])
def test_loader_branches_match_jax(ckpt, env, monkeypatch):
    """The loader's serving branches (tests/test_runbook_e2e.py:183-252 for
    JAX): dense by default on the CPU, int8 {"q8", "scale"} under
    REVISIONLLM_QUANT=int8, the serving chunks {"q8c"} / {"q8r"} and no
    "q8" under REVISIONLLM_SERVE=1; every leaf of both trees equal to JAX's
    engine's, int8 values and scales to the bit."""
    for k in ("REVISIONLLM_QUANT", "REVISIONLLM_SERVE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jeng = jloader.build_engine_from_args(jstage1.parse_args(_argv(ckpt, "s1")))
    teng = tloader.build_engine_from_args(tstage1.parse_args(_argv(ckpt, "s1") + ["--device", "cpu"]))
    assert teng.device.type == "cpu" and teng.eos_id == jeng.eos_id == 2
    for jtree, ttree in ((jeng.params, teng.params), (jeng.vision_params, teng.vision_params)):
        want, got = _flat(jtree), _flat(ttree)
        assert set(got) == set(want)
        for k, (dt, w) in want.items():
            gdt, g = got[k]
            assert str(gdt).removeprefix("torch.") == dt, k
            assert np.array_equal(g, w), k
    q = teng.params["layers"]["q_proj"]
    if not env:
        assert isinstance(q, torch.Tensor) and q.dtype == torch.bfloat16
    elif "REVISIONLLM_SERVE" in env:
        assert set(q) == {"q8c", "scale"} and "q8r" in teng.params["layers"]["down_proj"]
    else:
        assert set(q) == {"q8", "scale"} and q["q8"].dtype == torch.int8
        assert isinstance(teng.params["layers"]["attn_norm"], torch.Tensor)


def test_loader_refuses_before_reading_a_file(monkeypatch, tmp_path):
    """Without CUDA and without --device the mains raise before they read a
    file; so does a --mesh that this one process cannot fill."""
    def no_read(*a, **k):
        raise AssertionError("read a file")

    monkeypatch.setattr(tconv, "load_pretrained", no_read)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--model_base", str(tmp_path / "missing"), "--data_path", "d.json",
            "--feat_folder", "f", "--log_path", str(tmp_path / "log")]
    for main in (tstage1.main, tstage2.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        tloader.build_engine_from_args(tstage1.parse_args(argv + ["--mesh", "1,1,2",
                                                                 "--device", "cpu"]))
    assert not (tmp_path / "log").exists()


@pytest.fixture
def f32_compute(monkeypatch):
    """Both packages' configs from HF with dtype float32 (see the module's
    docstring); the int8 and serving switches unset."""
    for mod in (jconv, tconv):
        read = mod.llama_config_from_hf
        monkeypatch.setattr(mod, "llama_config_from_hf",
                            lambda d, read=read: dataclasses.replace(read(d), dtype="float32"))
    for k in ("REVISIONLLM_QUANT", "REVISIONLLM_SERVE"):
        monkeypatch.delenv(k, raising=False)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_stage1_main_matches_jax(ckpt, tmp_path, quant, f32_compute, monkeypatch):
    """stage1.main from the checkpoint directory: the same JSONL records as
    JAX's stage1.main, dense and int8."""
    monkeypatch.setenv("REVISIONLLM_QUANT", quant)
    jstage1.main(_argv(ckpt, "s1", tmp_path / "jax"))
    tstage1.main(_argv(ckpt, "s1", tmp_path / "port") + ["--device", "cpu"])
    want = records(tmp_path / "jax")
    assert_records_equal(want, records(tmp_path / "port"), {"scores"})
    assert len(want) == 2 and all(len(r["answer"]) == 19 for r in want)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_stage2_main_matches_jax(ckpt, tmp_path, quant, f32_compute, monkeypatch):
    """stage2.main (hierarchy cls adapter) from the checkpoint directory: the
    same JSONL records as JAX's stage2.main, dense and int8."""
    monkeypatch.setenv("REVISIONLLM_QUANT", quant)
    jstage2.main(_argv(ckpt, "s2", tmp_path / "jax"))
    tstage2.main(_argv(ckpt, "s2", tmp_path / "port") + ["--device", "cpu"])
    want = records(tmp_path / "jax")
    assert_records_equal(want, records(tmp_path / "port"),
                         {"score_cos", "mean_entropy", "max_entropy"})
    assert len(want) == 2


def test_tiny_checkpoint_matches_jax(tmp_path):
    """The port's build_tiny_hf_checkpoint writes JAX's files for one seed:
    config.json, the tokenizer's files and the same tensors."""
    kw = dict(hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64, seed=4,
              extra_words=["zebra"])
    j = jsynth.build_tiny_hf_checkpoint(str(tmp_path / "jax"), **kw)
    t = tsynth.build_tiny_hf_checkpoint(str(tmp_path / "port"), **kw)
    assert tsynth.SYNTH_WORDS == jsynth.SYNTH_WORDS
    names = sorted(os.listdir(j))
    assert names == sorted(os.listdir(t)) and "tokenizer.json" in names
    for name in names:
        if name.endswith(".safetensors"):
            want = tconv.read_safetensors(os.path.join(j, name))
            got = tconv.read_safetensors(os.path.join(t, name))
            assert set(got) == set(want)
            assert all(np.array_equal(got[k], want[k]) for k in want)
        elif name == "config.json":
            with open(os.path.join(j, name)) as a, open(os.path.join(t, name)) as b:
                assert json.load(a) == json.load(b)
        else:
            assert filecmp.cmp(os.path.join(j, name), os.path.join(t, name), shallow=False), name
