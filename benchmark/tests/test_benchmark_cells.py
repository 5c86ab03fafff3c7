"""Every cell of BENCHMARK.json end to end on the CPU at toy sizes, on the
program's plain kernel versions, and the result line's keys."""

import json

import pytest
import torch

import run as R
from benchlib.cell import benchmark_spec
from small import small_cell

SPEC = benchmark_spec()
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
LIMITS = {"malformed_queries": 0, "logit_gap": 1.0, "entropy_gap": 1.0}


@pytest.fixture(autouse=True)
def environment():
    R.prepare_environment()


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_end_to_end(workload, trace):
    cell = small_cell(workload, LIMITS)
    out = json.loads(json.dumps(R.run_cell(workload, 2**31 + 12345, 0.5, bool(trace),
                                           device="cpu", cell=cell)))
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device"] + (
        ["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        # the CPU has no device trace: only the host-clock metric is read
        assert set(out["metrics"]) == {"mfu.serve"}
    else:
        want = {m["name"] for m in SPEC["end_to_end"]}
        assert set(out["metrics"]) == want
        assert all(m["value"] > 0 for m in out["metrics"].values())
    assert set(out["checks"]) == set(LIMITS)
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_same_seed_same_inputs():
    from benchlib import traffic as TR
    from benchlib import weights as Wt

    cell = small_cell(WORKLOADS[0])
    a = [next(TR.queries(cell["traffic"], 7)) for _ in range(2)]
    assert a[0].sentence == a[1].sentence and (a[0].query_feats == a[1].query_feats).all()
    m1 = Wt.layer_matrices(cell["dims"], 7, 1, "cpu")
    m2 = Wt.layer_matrices(cell["dims"], 7, 1, "cpu")
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert not torch.equal(m1["q_proj"], Wt.layer_matrices(cell["dims"], 8, 1, "cpu")["q_proj"])


def test_every_seed_asks_the_same_work():
    from benchlib import traffic as TR

    mix = small_cell(WORKLOADS[0])["traffic"]
    lo, hi = mix["sentence_words"]
    cycle = hi - lo + 1
    for seed in (1, 2**33 + 5):
        gen = TR.queries(mix, seed)
        words = sorted(next(gen).words for _ in range(cycle))
        assert words == list(range(lo, hi + 1))


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = R.main(["--workload", WORKLOADS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
