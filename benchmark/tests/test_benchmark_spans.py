"""The seven readers of the program's spans (benchlib/spans.py,
metrics/*.py) on fabricated span records with known numbers, and the
helper: nothing on the CPU or without the program's spans, the traced
queries once a run."""

import sys

import pytest
import torch

import run as R
from benchlib import spans as BS
from benchlib.cell import benchmark_spec, module

MS = 1_000_000  # ns


@pytest.fixture(autouse=True)
def environment():
    R.prepare_environment()


def _rec(ids, name, request, parent, start_ms, end_ms, device_ms=None, **attrs):
    i = next(ids)
    return {"name": name, "id": i, "parent": parent, "request": request,
            "start_ns": int(start_ms * MS), "end_ns": int(end_ms * MS),
            "host_ms": end_ms - start_ms, "attrs": attrs, "device_ms": device_ms,
            "device_start_ms": None, "device_end_ms": None}


def _query(ids, request, t0, adapter, prefill, steps, step_host, read_end, chunk):
    """One query's spans, starting at t0 ms: plan 2 ms, one chunk, its
    decode steps (device ms each in `steps`, host ms `step_host` each),
    a read ending at read_end, finalize 3 ms."""
    root = _rec(ids, "engine.ground_windows", request, None, t0, read_end + 5, windows=57)
    out = [root, _rec(ids, "engine.plan", request, root["id"], t0, t0 + 2, shipped_bytes=0)]
    ch = _rec(ids, "engine.chunk", request, root["id"], t0 + 2, t0 + 50, **chunk)
    gen = _rec(ids, "model.generate", request, ch["id"], t0 + 4, t0 + 50)
    out += [ch, _rec(ids, "model.adapter", request, ch["id"], t0 + 2, t0 + 3, adapter),
            _rec(ids, "model.splice", request, ch["id"], t0 + 3, t0 + 4, 0.1), gen,
            _rec(ids, "model.prefill", request, gen["id"], t0 + 4, t0 + 10, prefill)]
    t = t0 + 10
    for g, d in enumerate(steps):
        out.append(_rec(ids, "model.decode_step", request, gen["id"], t, t + step_host, d,
                        step=g))
        t += step_host
    out.append(_rec(ids, "engine.read", request, root["id"], t0 + 50, read_end))
    out.append(_rec(ids, "engine.finalize", request, root["id"], read_end, read_end + 3,
                    proposals=4))
    return out


def _run():
    ids = iter(range(1, 1000))
    recs = (_query(ids, 1, 0.0, 4.0, 800.0, [9.0, 10.0, 11.0], 12.0, 130.0,
                   {"rows": 64, "live_rows": 57, "positions": 64 * 308,
                    "live_positions": 57 * 296})
            + _query(ids, 2, 200.0, 6.0, 900.0, [10.0, 10.5, 12.0], 8.0, 300.0,
                     {"rows": 64, "live_rows": 57, "positions": 64 * 320,
                      "live_positions": 57 * 308}))
    return {"cell": None, "driver": None, "records": [], "spans": {"queries": [], "records": recs}}


# the last step of query 1 ends at 10 + 3 x 12 = 46 ms, its read at 130;
# query 2's at 200 + 10 + 24 = 234 and 300
WANT = {
    "adapter_ms_per_query": (4.0 + 6.0) / 2,
    "prefill_ms_per_query": (800.0 + 900.0) / 2,
    "decode_ms_per_step": 10.25,
    "decode_enqueue_ms_per_step": 10.0,
    "engine_host_ms_per_query": (2 + 3 + 2 + 3) / 2,
    "device_lag_ms_per_query": ((130 - 46) + (300 - 234)) / 2,
    "prefill_useful_pct": 100.0 * 57 * (296 + 308) / (64 * (308 + 320)),
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_known_spans(name):
    assert module("metrics", name).read(_run()) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_nothing_without_spans(name):
    run = _run()
    run["spans"] = None
    assert module("metrics", name).read(run) is None


def test_device_readers_read_nothing_without_device_intervals():
    run = _run()
    for r in run["spans"]["records"]:
        r["device_ms"] = None
    for name in ("adapter_ms_per_query", "prefill_ms_per_query", "decode_ms_per_step"):
        assert module("metrics", name).read(run) is None
    assert module("metrics", "decode_enqueue_ms_per_step").read(run) == 10.0


class _Driver:
    def __init__(self, device):
        self.device = torch.device(device)
        self.calls = 0

    def traced(self, n):
        from revisionllm_tpu_torch.utils import spans

        self.calls += 1
        out = []
        for _ in range(n):
            with spans.span("engine.ground_windows"):
                with spans.span("model.decode_step", step=0):
                    pass
            out.append({"latency_s": 0.5})
        return out


def _helper_run(device):
    return {"cell": {"traffic": {"trace_queries": 2}}, "driver": _Driver(device),
            "records": [{"latency_s": 0.4}, {"latency_s": 0.6}]}


def test_helper_reads_nothing_on_the_cpu():
    run = _helper_run("cpu")
    assert BS.traced(run) is None and run["driver"].calls == 0


def test_helper_reads_nothing_without_the_programs_spans(monkeypatch):
    import revisionllm_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "revisionllm_tpu_torch.utils.spans", None)
    run = _helper_run("cuda")  # a device type alone: nothing runs on it
    assert BS.traced(run) is None and run["driver"].calls == 0


def test_helper_traces_the_queries_once_with_spans_on(capsys):
    from revisionllm_tpu_torch.utils import spans

    run = _helper_run("cuda")
    got = BS.traced(run)
    assert BS.traced(run) is got and run["driver"].calls == 1
    assert len(got["queries"]) == 2
    assert [r["name"] for r in got["records"]] == ["model.decode_step", "engine.ground_windows"] * 2
    assert len(BS.roots(got["records"])) == 2
    with spans.span("after"):
        pass
    assert spans.records() == []  # off and empty after
    err = capsys.readouterr().err
    assert "median latency 500.00 ms; the window's 500.00 ms" in err
    assert err.count("root host") == 2


def test_the_readers_are_in_the_benchmark_for_both_cells():
    names = {m["name"]: m for m in benchmark_spec()["per_layer"]}
    for name in WANT:
        assert names[name]["workloads"] == ["glm2-6b.ground-1h", "deepseek-7b.ground-1h"]
