"""What decides `correct`, on the CPU at toy sizes and with each cell's own
limits: the plain reference agrees with the program; the control (the
program's int4 path, the precision below the configuration's int8) does
not; and a run whose timed path is broken underneath comes out not
correct, for each fault a serving cell can have: a token altered where it
is produced, and half of the batch left out (its rows given the other
half's outputs)."""

import pytest
import torch

import readings as RD
import run as R
from benchlib.cell import benchmark_spec
from small import small_cell

WORKLOADS = [w["name"] for w in benchmark_spec()["workloads"]]


@pytest.fixture(autouse=True)
def environment():
    R.prepare_environment()


def judged(cell, fmt, seeds=(21, 22, 23)):
    return RD.readings(cell, list(seeds), fmt, 3, "cpu")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_agrees_and_the_control_fails(workload):
    cell = small_cell(workload)
    limits = cell["limits"]
    for row in judged(cell, "int8"):
        assert all(row[k] <= limits[k] for k in limits), row
    for row in judged(cell, "int4"):
        assert any(row[k] > limits[k] for k in limits), row


def _faulty_generate(monkeypatch, fault):
    from revisionllm_tpu_torch.models import generation

    real = generation.generate

    def generate(*args, **kwargs):
        out = real(*args, **kwargs)
        tok, ent = out["tokens"].clone(), out["entropy"].clone()
        if fault == "token":
            # the token of step 1 of the first row, changed where it is produced
            tok[0, 1] = (tok[0, 1] + 7) % args[0].vocab_size
        else:
            # half of the batch left out: its rows get the first half's outputs
            B = tok.shape[0]
            tok[B // 2:], ent[B // 2:] = tok[: B - B // 2], ent[: B - B // 2]
        out["tokens"], out["entropy"] = tok, ent
        return out

    monkeypatch.setattr(generation, "generate", generate)


@pytest.mark.parametrize("fault", ["token", "half_batch"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    cell = small_cell(workload)
    out = R.run_cell(workload, 31, 0.3, False, device="cpu", cell=cell)
    assert out["correct"] is True, out["checks"]
    _faulty_generate(monkeypatch, fault)
    out = R.run_cell(workload, 31, 0.3, False, device="cpu", cell=cell)
    assert out["correct"] is False, out["checks"]


@pytest.mark.h100
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_on_the_card(workload):
    """At the cell's own size on the card: one seed of the program within
    the limits, one of the int4 control beyond them (benchmark/readings.py
    reads a dozen and three)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA H100")
    from benchlib.cell import cell as find_cell

    cell = find_cell(workload)
    limits = cell["limits"]
    (row,) = RD.readings(cell, [2**31 + 99], "int8", 4, "cuda")
    assert all(row[k] <= limits[k] for k in limits), row
    (row,) = RD.readings(cell, [2**31 + 98], "int4", 4, "cuda")
    assert any(row[k] > limits[k] for k in limits), row
