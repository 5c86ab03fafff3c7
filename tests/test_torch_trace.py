"""utils/spans.py and the spans the stage-1 path opens (eval/engine.py,
models/revisionllm.py, models/generation.py, parallel/comm.py), on the CPU:
off they cost nothing and record nothing; on they form one tree a request
with the chunk's counts; the outputs do not change; self time; the
profiler sees them; a collective's span carries its bytes."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from revisionllm_tpu_torch.config import AdapterConfig, EvalConfig, LlamaConfig
from revisionllm_tpu_torch.constants import QUESTIONS
from revisionllm_tpu_torch.eval.engine import GroundingEngine
from revisionllm_tpu_torch.models import llama, revisionllm
from revisionllm_tpu_torch.parallel import comm
from revisionllm_tpu_torch.parallel.mesh import Mesh
from revisionllm_tpu_torch.utils import spans
from revisionllm_tpu_torch.utils.testing import FakeTokenizer

torch.set_num_threads(2)

# 400 frames in windows of 40: 19 windows, chunks of 4 (the last padded
# by one row), 6 new tokens: 5 decode steps a chunk
EVAL = dict(debug_window=20, num_frames=16, feature_fps=2.0, batch=4, stride=2, max_new_tokens=6)
WINDOWS, CHUNKS, TAIL_LIVE, STEPS = 19, 5, 3, 5
SENTENCE = "a red car drives by."
STAGE1 = ("engine.ground_windows", "engine.plan", "engine.chunk", "engine.read",
          "engine.finalize", "model.adapter", "model.splice", "model.generate", "model.prefill",
          "model.decode_step")


class CapturingEngine(GroundingEngine):
    """Keeps each chunk's tokens and entropies as `_read_chunk` reads them."""

    def _read_chunk(self, out):
        self.captured.append((out["tokens"].clone(), out["entropy"].clone()))
        return super()._read_chunk(out)


@pytest.fixture(scope="module")
def engine():
    cfg = LlamaConfig(**{**LlamaConfig.tiny(512).__dict__, "dtype": "float32"})
    acfg = AdapterConfig(d_model=16, num_heads=4, num_layers=2, ffn_dim=32,
                         hidden_size=cfg.hidden_size, clip_adapter_text=True, hierarchy=False,
                         feature_mode="temporal")
    tok = FakeTokenizer()
    for i in range(300):
        tok._id(str(i))
    eng = CapturingEngine(cfg, acfg, llama.init_params(cfg, 0, torch.float32, "cpu"),
                          revisionllm.init_vision_params(acfg, 1, d_in=16, device="cpu"), tok,
                          EvalConfig(**EVAL), device="cpu")
    eng.captured = []
    return eng


@pytest.fixture(scope="module")
def query():
    rng = np.random.default_rng(0)
    movie = rng.normal(size=(400, 16)).astype(np.float32)
    qf = rng.normal(size=(3, 16)).astype(np.float32)
    qc = rng.normal(size=(16,)).astype(np.float32)
    return movie, qf, qc / np.linalg.norm(qc)


@pytest.fixture(autouse=True)
def clean_spans():
    spans.enable(False)
    spans.reset()
    yield
    spans.enable(False)
    spans.reset()


def _ground(engine, query, movie_key):
    movie, qf, qc = query
    engine.captured = []
    res = engine.ground_windows(movie, SENTENCE, qf, qc, movie_key=movie_key)
    return res, engine.captured


def test_off_without_profiler_is_the_shared_null_and_records_nothing(engine, query):
    assert not torch.autograd._profiler_enabled()
    a = spans.span("engine.plan")
    b = spans.span("model.decode_step", device=torch.device("cpu"), step=3)
    assert a is b
    with a as entered:
        spans.note(rows=4)
    assert entered is None
    _ground(engine, query, None)
    assert spans.records() == [] and spans.summary() == {}
    with spans.enabled():
        spans.note(rows=4)  # no span open: nothing to add to
        with spans.span("x"):
            pass
    assert [r["name"] for r in spans.records()] == ["x"]
    with spans.span("y"):  # off again after the block
        pass
    assert len(spans.records()) == 1


def test_stage1_span_tree_with_a_padded_tail_chunk(engine, query):
    movie = query[0]
    with spans.enabled():
        _ground(engine, query, "movie0")
        _ground(engine, query, "movie0")  # the cached movie ships nothing
    recs = spans.records()
    assert {r["name"] for r in recs} == set(STAGE1)
    by_id = {r["id"]: r for r in recs}
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["engine.ground_windows"] * 2
    assert roots[0]["request"] != roots[1]["request"]
    ids = engine._prompt_ids(SENTENCE, QUESTIONS["mad_grounding"])
    prompt = len(ids) - 1 + EVAL["num_frames"]
    T = prompt + EVAL["max_new_tokens"]
    for q, root in enumerate(roots):
        mine = [r for r in recs if r["request"] == root["request"]]
        assert all(r["end_ns"] <= root["end_ns"] and r["start_ns"] >= root["start_ns"]
                   for r in mine)
        assert root["attrs"] == {"windows": WINDOWS}

        def kids(parent, name):
            return [r for r in mine if r["parent"] == parent["id"] and r["name"] == name]

        (plan,) = kids(root, "engine.plan")
        assert plan["attrs"] == {"shipped_bytes": movie.nbytes if q == 0 else 0}
        chunks = kids(root, "engine.chunk")
        assert [c["attrs"]["live_rows"] for c in chunks] == [4] * (CHUNKS - 1) + [TAIL_LIVE]
        for c in chunks:
            assert c["attrs"] == {"rows": 4, "live_rows": c["attrs"]["live_rows"],
                                  "positions": 4 * T,
                                  "live_positions": c["attrs"]["live_rows"] * prompt}
            for name in ("model.adapter", "model.splice", "model.generate"):
                assert len(kids(c, name)) == 1
            (gen,) = kids(c, "model.generate")
            assert len(kids(gen, "model.prefill")) == 1
            steps = kids(gen, "model.decode_step")
            assert [s["attrs"]["step"] for s in steps] == list(range(STEPS))
        assert len(kids(root, "engine.read")) == CHUNKS
        (fin,) = kids(root, "engine.finalize")
        assert set(fin["attrs"]) == {"proposals"}
        # root, plan, finalize; a chunk, its read, adapter, splice, generate,
        # prefill and steps
        assert len(mine) == 3 + CHUNKS * (6 + STEPS)
        # each span lies inside its parent; the CPU has no device interval
        for r in mine:
            if r["parent"] is not None:
                p = by_id[r["parent"]]
                assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] <= p["end_ns"]
            assert r["device_ms"] is None and r["device_start_ms"] is None
    s = spans.summary()
    assert s["model.decode_step"]["count"] == 2 * CHUNKS * STEPS
    assert s["engine.chunk"]["count"] == 2 * CHUNKS and s["engine.chunk"]["device_ms"] is None


def test_outputs_bit_equal_with_spans_on_and_off(engine, query):
    off, cap_off = _ground(engine, query, None)
    with spans.enabled():
        on, cap_on = _ground(engine, query, None)
    assert spans.records()
    assert on["answers"] == off["answers"] and on["frames"] == off["frames"]
    assert on["scores_entropy"] == off["scores_entropy"] and on["scores"] == off["scores"]
    assert len(cap_on) == len(cap_off) == CHUNKS
    for (t1, e1), (t0, e0) in zip(cap_on, cap_off):
        assert torch.equal(t1, t0) and torch.equal(e1, e0)


def test_self_time_is_duration_less_the_childrens_cover(monkeypatch):
    ticks = iter([0, 10, 30, 40, 70, 100])  # root [0, 100], a [10, 30], b [40, 70]
    monkeypatch.setattr(spans, "_clock", lambda: next(ticks) * 1_000_000)
    with spans.enabled():
        with spans.span("root"):
            with spans.span("a"):
                pass
            with spans.span("b"):
                pass
    s = spans.summary()
    assert s["root"] == {"count": 1, "host_ms": 100.0, "self_host_ms": 50.0, "device_ms": None}
    assert s["a"]["self_host_ms"] == 20.0 and s["b"]["self_host_ms"] == 30.0
    # overlapping children (two threads' spans under one parent) count once,
    # and a child's part outside its parent not at all
    recs = [
        {"name": "p", "id": 1, "parent": None, "start_ns": 0, "end_ns": 100_000_000},
        {"name": "c", "id": 2, "parent": 1, "start_ns": 10_000_000, "end_ns": 50_000_000},
        {"name": "c", "id": 3, "parent": 1, "start_ns": 30_000_000, "end_ns": 60_000_000},
        {"name": "c", "id": 4, "parent": 1, "start_ns": 90_000_000, "end_ns": 120_000_000},
    ]
    assert spans.self_host_ms(recs) == {1: 40.0, 2: 40.0, 3: 30.0, 4: 30.0}


def test_self_times_of_a_request_add_up_to_its_root(engine, query):
    with spans.enabled():
        _ground(engine, query, None)
    recs = spans.records()
    (root,) = [r for r in recs if r["parent"] is None]
    own = spans.self_host_ms(recs)
    assert all(v >= 0 for v in own.values())
    assert sum(own.values()) == pytest.approx(root["host_ms"], rel=1e-9)


@pytest.mark.parametrize("on", [False, True], ids=["spans_off", "spans_on"])
def test_spans_are_profiler_ranges(engine, query, on):
    with spans.enabled(on):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _ground(engine, query, None)
    names = [e.name for e in prof.events()]
    for name in STAGE1:
        assert name in names, name
    assert names.count("model.decode_step") == CHUNKS * STEPS
    assert bool(spans.records()) == on


def test_comm_spans_carry_their_bytes_on_a_one_process_gloo_group(tmp_path):
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        mesh = Mesh(1, 1, 1, groups={"tensor": dist.group.WORLD})
        t = torch.arange(6, dtype=torch.float32)
        comm.reset_stats()
        with spans.enabled():
            with spans.span("step"):
                comm.all_reduce(t, mesh, "tensor")
                g = comm.all_gather(t.reshape(2, 3), mesh, "tensor", dim=1)
    finally:
        dist.destroy_process_group()
    assert torch.equal(t, torch.arange(6, dtype=torch.float32)) and g.shape == (2, 3)
    recs = {r["name"]: r for r in spans.records()}
    assert recs["comm.all_reduce"]["attrs"] == {"bytes": 24}
    assert recs["comm.all_gather"]["attrs"] == {"bytes": 24}
    assert recs["comm.all_reduce"]["parent"] == recs["step"]["id"]
    assert dict(comm.STATS) == {"all_reduce": 1, "all_reduce_bytes": 24, "all_gather": 1,
                                "all_gather_bytes": 24}
    assert recs["comm.all_reduce"]["device_ms"] is None and recs["comm.all_reduce"]["host_ms"] > 0
