"""Port train CLI smoke on the CPU: a tiny model over a tiny corpus, two
steps, the metric log, auto-resume to step 3, and the reference-format
artifacts with the keys, shapes and dtypes of the JAX package's export."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from revisionllm_tpu.config import LlamaConfig as JL
from revisionllm_tpu.config import get_preset as jpreset
from revisionllm_tpu.models import lora as jlora
from revisionllm_tpu.models import revisionllm as jrev
from revisionllm_tpu.train import checkpoint as jckpt
from revisionllm_tpu_torch.train import checkpoint as tckpt
from revisionllm_tpu_torch.train import train_cli

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def train_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("traindata")
    fps, dur = 2.0, 300.0
    feats = np.random.default_rng(0).normal(size=(int(dur * fps), 16)).astype(np.float32)
    np.save(root / "movie1.npy", feats)
    records = [
        {
            "id": "movie1",
            "query_id": f"q{k}",
            "conversations": [
                {"from": "human", "value": "<video>\nDuring which frames can we see a dog?"},
                {"from": "gpt", "value": "From <s0> to <e0>."},
            ],
            "meta": {"duration": dur, "token": {"<s0>": 100.0 + k, "<e0>": 110.0 + k}},
            "source": "mad",
        }
        for k in range(6)
    ]
    with open(root / "train.json", "w") as f:
        json.dump(records, f)
    return root


def _args(train_data, out_dir, max_steps, save_steps):
    return [
        "--preset", "stage1_dense",
        "--data_path", str(train_data / "train.json"),
        "--feat_folder", str(train_data),
        "--output_dir", out_dir,
        "--tiny_model", "--device", "cpu",
        "--max_steps", str(max_steps),
        "--per_device_batch_size", "2",
        "--save_steps", str(save_steps),
        "--log_steps", "1",
        "--model_max_length", "256",
    ]


def _jax_export(out_dir):
    """The JAX package's export of the same tiny LoRA and adapter trees."""
    wl = jpreset("stage1_dense")
    cfg = JL(**{**JL.tiny().__dict__, "dtype": "float32"})
    acfg = wl.adapter.__class__(**{**wl.adapter.__dict__, "d_model": 16, "ffn_dim": 32,
                                   "hidden_size": cfg.hidden_size, "num_heads": 4})
    lora = jlora.init_lora(cfg, wl.train.lora, jax.random.PRNGKey(0))
    vision = jrev.init_vision_params(acfg, jax.random.PRNGKey(1), d_in=16)
    jckpt.export_reference_artifacts(out_dir, lora, wl.train.lora, vision=vision)


def test_train_resume_and_export(train_data, tmp_path):
    out_dir = str(tmp_path / "out")
    seen = []
    run, opt = train_cli.main(_args(train_data, out_dir, 2, 2),
                              on_step=lambda step, batch, m: seen.append((step, float(m["loss"]))))
    with open(os.path.join(out_dir, "train_log.jsonl")) as f:
        logs = [json.loads(line) for line in f]
    assert [entry["step"] for entry in logs] == [1, 2]
    assert all(np.isfinite(entry["loss"]) and np.isfinite(entry["grad_norm"]) for entry in logs)
    assert seen == [(entry["step"], entry["loss"]) for entry in logs]
    assert opt.count == 2 and run.batch([0])["lengths"].shape == (1,)
    assert tckpt.latest_checkpoint(out_dir).endswith("checkpoint-2")

    # resume picks up from checkpoint-2 and runs step 3 only
    train_cli.main(_args(train_data, out_dir, 3, 10))
    with open(os.path.join(out_dir, "train_log.jsonl")) as f:
        logs = [json.loads(line) for line in f]
    assert [entry["step"] for entry in logs] == [1, 2, 3]
    assert tckpt.latest_checkpoint(out_dir).endswith("checkpoint-3")

    ref = str(tmp_path / "jax_export")
    _jax_export(ref)
    for name in ("adapter_model.bin", "non_lora_trainables.bin"):
        got = torch.load(os.path.join(out_dir, name), weights_only=True)
        want = torch.load(os.path.join(ref, name), weights_only=True)
        assert set(got) == set(want), name
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    with open(os.path.join(out_dir, "adapter_config.json")) as f, \
            open(os.path.join(ref, "adapter_config.json")) as g:
        assert json.load(f) == json.load(g)


def test_checkpoint_round_trip_and_async_errors(tmp_path):
    """An async save restores equal to what was saved, even after the
    source tensors change in place; a failing background save raises in
    wait_for_checkpoints."""
    tr = {"lora": {"layers": {"q_proj": {"a": torch.randn(2, 8, 4), "b": torch.randn(2, 4, 8)}}},
          "vision": {"mm_projector": {"w": torch.randn(3, 5).to(torch.bfloat16)}}}
    saved = {k: v.clone() for k, v in tr["lora"]["layers"]["q_proj"].items()}
    tckpt.save_checkpoint(str(tmp_path), {"trainable": tr, "opt_state": {"count": 1}, "step": 7},
                          7, block=False)
    tr["lora"]["layers"]["q_proj"]["a"].add_(1.0)  # the next step updates in place
    tckpt.wait_for_checkpoints()
    latest = tckpt.latest_checkpoint(str(tmp_path))
    assert latest.endswith("checkpoint-7") and os.listdir(tmp_path) == ["checkpoint-7"]
    got = tckpt.restore_checkpoint(latest, {"trainable": tr})
    assert got["step"] == 7 and got["opt_state"] == {"count": 1}
    for k in ("a", "b"):
        assert torch.equal(got["trainable"]["lora"]["layers"]["q_proj"][k], saved[k])
    assert got["trainable"]["vision"]["mm_projector"]["w"].dtype == torch.bfloat16

    blocker = tmp_path / "blocked"
    blocker.write_text("a file where the checkpoint directory should go")
    tckpt.save_checkpoint(str(blocker), {"trainable": tr, "step": 1}, 1, block=False)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        tckpt.wait_for_checkpoints()


def test_cli_refuses_what_is_not_ported(train_data, tmp_path, monkeypatch):
    base = _args(train_data, str(tmp_path / "x"), 1, 1)
    with pytest.raises(NotImplementedError, match="distributed layer"):
        train_cli.main(base + ["--dp", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main([a for a in base if a not in ("--device", "cpu")])


_EXIT_WITHOUT_WAIT = r"""
import sys, time, torch
from revisionllm_tpu_torch.train import checkpoint as ck
write = ck._write
def slow_write(*a):
    time.sleep(1.0)
    write(*a)
ck._write = slow_write
ck.save_checkpoint(sys.argv[1], {"trainable": {"w": torch.ones(3)}, "step": 5}, 5, block=False)
raise SystemExit(3)  # an unclean exit, without wait_for_checkpoints
"""


def test_async_save_commits_on_unclean_exit(tmp_path):
    root = Path(__file__).resolve().parent.parent
    env = {**os.environ, "PYTHONPATH": str(root)}
    out = subprocess.run([sys.executable, "-c", _EXIT_WITHOUT_WAIT, str(tmp_path)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 3, out.stderr
    latest = tckpt.latest_checkpoint(str(tmp_path))
    assert latest is not None and latest.endswith("checkpoint-5")
    got = tckpt.restore_checkpoint(latest, {"trainable": {"w": torch.zeros(3)}})
    assert torch.equal(got["trainable"]["w"], torch.ones(3))

