"""Port parity: the sharded train step at the tensor-parallel meshes (1, 1, 2)
and (2, 2, 2) against revisionllm_tpu's make_sharded_train_step, by
tests/test_torch_parallel_train.py's setup and limits (there the data and
fsdp meshes); three sharded steps lower the loss; and train_cli --dp 2 over
two gloo ranks on the CPU: rank 0 alone writes the checkpoint, which equals
the one-process run's over the same global batch."""

import json
import os

import numpy as np
import pytest

from revisionllm_tpu_torch.train import checkpoint as tckpt
from revisionllm_tpu_torch.train import train_cli
from revisionllm_tpu_torch.train.trainer import tree_leaves

from test_torch_parallel_train import check_mesh, run_both
from torch_parallel_cases import run_ranks, train_cli_case

TENSOR = [(1, 1, 2), (2, 2, 2)]


@pytest.fixture(scope="module")
def results():
    return run_both(TENSOR, steps=3)


@pytest.mark.parametrize("shape", TENSOR, ids=["tensor2", "all2"])
def test_sharded_step_matches_jax_and_one_process(results, shape):
    check_mesh(results, shape)


def test_three_sharded_steps_lower_the_loss(results):
    """Memorizing one batch lowers its loss (the first step's learning rate
    is the warm-up's 0), as JAX's test_sharded_step_with_int8_base holds."""
    for plain, dropped in results["ranks"][(2, 2, 2)]:
        for case in (plain, dropped):
            assert all(np.isfinite(case["losses"]))
            assert case["losses"][-1] < case["losses"][0]


def _train_data(root):
    """tests/test_torch_train_cli.py's corpus: six queries over one 300 s
    movie of 16-d features at 2 fps."""
    feats = np.random.default_rng(0).normal(size=(600, 16)).astype(np.float32)
    np.save(root / "movie1.npy", feats)
    records = [{"id": "movie1", "query_id": f"q{k}", "source": "mad",
                "conversations": [
                    {"from": "human", "value": "<video>\nDuring which frames can we see a dog?"},
                    {"from": "gpt", "value": "From <s0> to <e0>."}],
                "meta": {"duration": 300.0, "token": {"<s0>": 100.0 + k, "<e0>": 110.0 + k}}}
               for k in range(6)]
    (root / "train.json").write_text(json.dumps(records))


def _argv(root, out, per_device, extra=()):
    return ["--preset", "stage1_dense", "--data_path", str(root / "train.json"),
            "--feat_folder", str(root), "--output_dir", str(out), "--tiny_model",
            "--device", "cpu", "--max_steps", "2", "--per_device_batch_size", str(per_device),
            "--save_steps", "2", "--log_steps", "1", "--model_max_length", "256", *extra]


def test_train_cli_dp2_writes_one_checkpoint(tmp_path):
    """train_cli --dp 2 --per_device_batch_size 1 over two gloo ranks trains
    on the global batch of 2 that one process trains with
    --per_device_batch_size 2 (the same items, the same adapter dropout):
    rank 0 alone writes checkpoint-2, the log and the export, every rank
    ends with the same trees, and the checkpoint equals the one-process
    run's within f32 sums in another order (1e-5 relative L2 a leaf)."""
    _train_data(tmp_path)
    ranks = run_ranks(train_cli_case, 2, _argv(tmp_path, tmp_path / "dp2", 1, ("--dp", "2")))
    one, _ = train_cli.main(_argv(tmp_path, tmp_path / "one", 2))
    (leaves0, wrote0), (leaves1, wrote1) = ranks
    assert [os.path.basename(p) for p in wrote0] == ["checkpoint-2"] and wrote1 == []
    for a, b in zip(leaves0, leaves1):
        np.testing.assert_array_equal(a, b)
    assert sorted(os.listdir(tmp_path / "dp2")) == sorted(os.listdir(tmp_path / "one"))
    with open(tmp_path / "dp2" / "train_log.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2]
    got = tckpt.restore_checkpoint(str(tmp_path / "dp2" / "checkpoint-2"),
                                   {"trainable": one.trainable})
    want = tckpt.restore_checkpoint(str(tmp_path / "one" / "checkpoint-2"),
                                    {"trainable": one.trainable})
    assert got["step"] == want["step"] == 2
    for g, w in zip(tree_leaves(got["trainable"]), tree_leaves(want["trainable"])):
        assert (g - w).norm() <= 1e-5 * w.norm() + 1e-7
