"""The trained witness: the port serves what the JAX package trains, and the
JAX package serves what the port trains.

JAX's train_cli trains the tiny synthetic checkpoint (a word-level HF Llama,
hidden 128, 2 layers) through the synthetic learning demo's three stages
(scripts/synthetic_learning_demo.py:62-113: stage-1 dense grounding with
the mlp projector, the sparse ClipEncoder pretraining over the stage-1 LoRA,
stage-2 hierarchical retrieval at training_stage 3), a few steps each. The
port's stage1.main and stage2.main then write the JSONL records JAX's
mains write on those artifacts. The other way round, the port's train_cli
trains stage 1 from the same flags and JAX's stage1.main on the port's
export writes the port's records; and the port's train_cli trains the sparse
and stage-2 stages over JAX's stage-1 LoRA, and JAX's stage2.main on the
port's stage-2 export writes the port's records.

Both packages read the weights as bf16 and compute in f32 (their
llama_config_from_hf patched to dtype float32, as tests/test_torch_loader.py
does): the records agree in every field, the scores within rtol 1e-4."""

import dataclasses
import os

import pytest
import torch

from revisionllm_tpu.data import synthetic as jsynth
from revisionllm_tpu.eval import stage1 as jstage1
from revisionllm_tpu.eval import stage2 as jstage2
from revisionllm_tpu.models import convert as jconv
from revisionllm_tpu.train import train_cli as jcli
from revisionllm_tpu_torch.eval import stage1 as tstage1
from revisionllm_tpu_torch.eval import stage2 as tstage2
from revisionllm_tpu_torch.models import convert as tconv
from revisionllm_tpu_torch.train import train_cli as tcli

from torch_parity import assert_records_equal, records

pytest.importorskip("transformers")
torch.set_num_threads(2)
STEPS = "3"


def _train_argv(w, preset, out):
    """The demo's train_cli flags for `preset`, STEPS steps."""
    c = w["corpus"]
    argv = ["--preset", preset, "--model_base", w["hf"], "--data_path", c["train_json"],
            "--feat_folder", c["features"], "--output_dir", out, "--max_steps", STEPS,
            "--save_steps", STEPS, "--log_steps", STEPS]
    if preset != "synthetic_tiny":
        argv += ["--stage2_path", w["s1"], "--q_feat_dir", c["queries"]]
    if preset == "synthetic_tiny_stage2":
        argv += ["--pretrain_clip_adapter", os.path.join(w["sparse"], "non_lora_trainables.bin")]
    return argv


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("witness")
    w = {"hf": jsynth.build_tiny_hf_checkpoint(str(root / "hf")),
         "corpus": jsynth.make_synthetic_corpus(str(root / "corpus"), n_train_movies=2,
                                                n_val_movies=1, duration=270.0, seed=3)}
    for stage, preset in (("s1", "synthetic_tiny"), ("sparse", "synthetic_tiny_sparse"),
                          ("s2", "synthetic_tiny_stage2")):
        w[stage] = str(root / stage)
        jcli.main(_train_argv(w, preset, w[stage]))
    return w


@pytest.fixture
def f32_compute(monkeypatch):
    for mod in (jconv, tconv):
        read = mod.llama_config_from_hf
        monkeypatch.setattr(mod, "llama_config_from_hf",
                            lambda d, read=read: dataclasses.replace(read(d), dtype="float32"))
    for k in ("REVISIONLLM_QUANT", "REVISIONLLM_SERVE"):
        monkeypatch.delenv(k, raising=False)


def _eval_common(w):
    c = w["corpus"]
    return ["--model_base", w["hf"], "--data_path", c["val_json"], "--feat_folder",
            c["features"], "--q_feat_dir", c["queries"], "--debug_window", "90",
            "--num_frames", "16", "--feature_fps", "1", "--max_new_tokens", "8",
            "--debug", "True"]


def _stage1_argv(w, s1, log):
    return _eval_common(w) + ["--stage2", s1, "--log_path", str(log), "--batch", "8",
                              "--skip_small_videos", "False"]


def test_port_serves_the_jax_trained_checkpoint(world, tmp_path, f32_compute):
    """stage1.main, then stage2.main prefiltered by its log (the demo's eval
    chain), on JAX's trained artifacts: the port's records equal JAX's."""
    for pkg, s1, s2 in (("jax", jstage1, jstage2), ("port", tstage1, tstage2)):
        dev = [] if pkg == "jax" else ["--device", "cpu"]
        g, r = tmp_path / pkg / "grounding", tmp_path / pkg / "retrieval"
        s1.main(_stage1_argv(world, world["s1"], g) + dev)
        s2.main(_eval_common(world) + [
            "--stage2", world["s1"], "--stage3", world["s2"], "--log_path", str(r),
            "--batch", "8", "--stride", "5",
            "--pretrain_clip_adapter", os.path.join(world["s2"], "non_lora_trainables.bin"),
            "--adapter_d_model", "16", "--adapter_heads", "4", "--adapter_layers", "2",
            "--adapter_ffn", "32", "--zooms", "1", "--retrieval_prompt", "mad_grounding",
            "--grounding_path", str(g), "--distributed_retrieval", "1"] + dev)
    want = records(tmp_path / "jax" / "grounding")
    assert_records_equal(want, records(tmp_path / "port" / "grounding"), {"scores"})
    assert_records_equal(records(tmp_path / "jax" / "retrieval"),
                         records(tmp_path / "port" / "retrieval"),
                         {"score_cos", "mean_entropy", "max_entropy"})
    assert len(want) == 4 and all(r["answer"] for r in want)


def test_jax_serves_the_port_trained_checkpoint(world, tmp_path, f32_compute):
    """The port's train_cli trains stage 1 from the demo's flags; JAX's
    stage1.main on the port's export writes the port's records."""
    out = str(tmp_path / "port_s1")
    run, _ = tcli.main(_train_argv(world, "synthetic_tiny", out) + ["--device", "cpu"])
    assert run.llama_cfg.hidden_size == 128 and run.adapter_cfg.kind == "mlp"
    assert {"adapter_config.json", "adapter_model.bin",
            "non_lora_trainables.bin"} <= set(os.listdir(out))
    jstage1.main(_stage1_argv(world, out, tmp_path / "jax"))
    tstage1.main(_stage1_argv(world, out, tmp_path / "port") + ["--device", "cpu"])
    want = records(tmp_path / "jax")
    assert_records_equal(want, records(tmp_path / "port"), {"scores"})
    assert len(want) == 4


def _stage2_argv(w, s2, log):
    """stage2.main over the whole movie (no grounding log) with the stage-2
    LoRA and projector of `s2`."""
    return _eval_common(w) + [
        "--stage2", w["s1"], "--stage3", s2, "--log_path", str(log), "--batch", "8",
        "--stride", "5", "--pretrain_clip_adapter", os.path.join(s2, "non_lora_trainables.bin"),
        "--adapter_d_model", "16", "--adapter_heads", "4", "--adapter_layers", "2",
        "--adapter_ffn", "32", "--zooms", "1", "--retrieval_prompt", "mad_grounding",
        "--distributed_retrieval", "1"]


def test_jax_serves_the_port_trained_stage2(world, tmp_path, f32_compute):
    """The round trip: the port's train_cli trains the sparse stage over
    JAX's stage-1 LoRA, then the stage-2 stage from its own sparse
    projector, both from the demo's flags; JAX's stage2.main on the port's
    stage-2 export writes the port's records."""
    w = {**world, "sparse": str(tmp_path / "port_sparse")}
    for preset, out in (("synthetic_tiny_sparse", w["sparse"]),
                        ("synthetic_tiny_stage2", str(tmp_path / "port_s2"))):
        run, _ = tcli.main(_train_argv(w, preset, out) + ["--device", "cpu"])
        assert "non_lora_trainables.bin" in os.listdir(out)
    assert run.adapter_cfg.hierarchy and run.train_cfg.training_stage == 3
    assert "adapter_config.json" in os.listdir(out)
    jstage2.main(_stage2_argv(w, out, tmp_path / "jax"))
    tstage2.main(_stage2_argv(w, out, tmp_path / "port") + ["--device", "cpu"])
    want = records(tmp_path / "jax")
    assert_records_equal(want, records(tmp_path / "port"),
                         {"score_cos", "mean_entropy", "max_entropy"})
    assert len(want) == 4
