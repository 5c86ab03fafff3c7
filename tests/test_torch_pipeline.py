"""Port parity for the fused recursive pipeline: stage-2 retrieval
(eval/engine.py retrieve, retrieve_batch and their scoring tail), the
multi-query stage-1 path (ground_windows_batch), the hierarchy adapter
input, the shared-prefix switch, the strided window planning, the metrics
and the stage-1 -> stage-2 --grounding_path -> fusion CLIs, against
revisionllm_tpu on the CPU (tiny f32 Llama, narrow ClipEncoder adapter)."""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revisionllm_tpu.config import AdapterConfig as JAdapter
from revisionllm_tpu.data import prefetcher as jprefetch
from revisionllm_tpu.eval import fusion as jfusion
from revisionllm_tpu.eval import loader as jloader
from revisionllm_tpu.eval import metrics as JM
from revisionllm_tpu.eval import stage1 as jstage1
from revisionllm_tpu.eval import stage2 as jstage2
from revisionllm_tpu.eval.engine import GroundingEngine as JEngine
from revisionllm_tpu.models import revisionllm as jrl
from revisionllm_tpu.ops import windows as jwin
from revisionllm_tpu.utils.cli import str2bool as jstr2bool
from revisionllm_tpu_torch.config import AdapterConfig as TAdapter
from revisionllm_tpu_torch.constants import QUESTIONS
from revisionllm_tpu_torch.data import prefetcher as tprefetch
from revisionllm_tpu_torch.eval import fusion as tfusion
from revisionllm_tpu_torch.eval import loader as tloader
from revisionllm_tpu_torch.eval import metrics as TM
from revisionllm_tpu_torch.eval import stage1 as tstage1
from revisionllm_tpu_torch.eval import stage2 as tstage2
from revisionllm_tpu_torch.eval.engine import GroundingEngine as TEngine
from revisionllm_tpu_torch.models import revisionllm as trl
from revisionllm_tpu_torch.ops import windows as twin
from revisionllm_tpu_torch.utils.cli import str2bool

from torch_parity import (S1_EVAL, adapter_kw, assert_records_equal, assert_stage1_equal,
                          engines, np_of, records, to_torch)

torch.set_num_threads(2)

S2_EVAL = dict(debug_window=20, num_frames=16, feature_fps=2.0, batch=8, stride=5,
               max_new_tokens=4, hierarchy_zooms=(2, 1))


@pytest.fixture(scope="module")
def s2_engines():
    return engines(True, S2_EVAL)


@pytest.fixture(scope="module")
def movie():
    rng = np.random.default_rng(0)
    return rng.normal(size=(400, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def queries():
    rng = np.random.default_rng(1)
    out = []
    for i, s in enumerate(["a red car drives by.", "someone slowly opens the old door?"]):
        qf = rng.normal(size=(3 + i, 16)).astype(np.float32)  # ragged Qt
        qc = rng.normal(size=(16,)).astype(np.float32)
        out.append({"sentence": s, "query_feats": qf, "query_cls": qc / np.linalg.norm(qc)})
    return out


def _warm(pair, queries, key):
    """Register every prompt's words in both FakeTokenizers first, so both
    decode generated ids through the same vocabulary whatever the call order."""
    for eng in pair:
        for q in queries:
            eng._prompt_ids(q["sentence"], QUESTIONS[key])


def _assert_retrieve_equal(want, got):
    """Identical answers, starts, permutations, zooms and windows;
    entropies and cosines within rtol 1e-4."""
    for k in ("answers", "starts", "indexes", "hierarchy_zooms", "grounding_windows",
              "num_windows"):
        assert got[k] == want[k], k
    for k in ("mean_entropy", "max_entropy", "score_cos"):
        np.testing.assert_allclose(np.asarray(got[k], np.float64), np.asarray(want[k], np.float64),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


# ------------------------------------------------------------ host pieces


@pytest.mark.parametrize("ctx,clip,stride", [(18000, 625, 5), (400, 40, 5), (75, 40, 5), (3000, 625, 5)])
def test_strided_window_planning_matches_jax(ctx, clip, stride):
    assert twin.num_windows_strided(ctx, clip, stride) == jwin.num_windows_strided(ctx, clip, stride)
    jb = jwin.strided_window_bounds(ctx, clip, stride)
    assert twin.strided_window_bounds(ctx, clip, stride) == jb
    for start, end, dur in ((1000.0, 1100.0, 3600.0), (0.0, 3.0, 60.0), (55.5, 300.2, 301.0)):
        assert twin.get_ground_truth_windows(start, end, dur) == \
            jwin.get_ground_truth_windows(start, end, dur)
    # a [rows, windows, frames] index gathers [rows, windows, frames, d]
    idx = np.asarray(jwin.window_frame_indices(jb, 8))[None].repeat(3, 0)
    feats = np.arange(ctx * 2, dtype=np.float32).reshape(ctx, 2)
    got = twin.gather_windows(torch.from_numpy(feats), idx)
    assert got.shape == idx.shape + (2,)
    np.testing.assert_array_equal(got.numpy(), feats[idx])


def _glog(answers, qid="q1"):
    return {"video_id": "m1", "task": "grounding", "query_id": qid, "answer": answers,
            "info": {"iou": [0.5] * sum(a != "Not Present" for a in answers),
                     "scores": [1.0] * sum(a != "Not Present" for a in answers)}}


@pytest.mark.parametrize("hits,nw,batch", [([0, 3], 23, 8), ([], 23, 8), ([5, 6, 7], 9, 4),
                                           (list(range(19)), 140, 100), ([18], 140, 100)])
def test_grounding_prefilter_matches_jax(hits, nw, batch):
    answers = ["Not Present"] * 19
    for i in hits:
        answers[i] = "From 1 to 5."
    assert tstage2.grounding_prefilter(_glog(answers), nw, 5, batch) == \
        jstage2.grounding_prefilter(_glog(answers), nw, 5, batch)


def test_stage2_metrics_and_fusion_match_jax():
    """stage2_window_hit, stage2_chosen_windows (with the within-zoom index
    quirk) and fuse_retrieval_grounding (both modes, with a second
    retrieval log and buffers) on synthetic logs."""
    rng = np.random.default_rng(3)
    answers = ["In video 3", "video 17 here", "Not Present", "In video 0", "In video 99"]
    starts = [0, 4, 8, 0, 6]
    indexes = [list(rng.permutation(8)) for _ in answers]
    zooms = [2, 2, 2, 1, 1]
    calls = [0, 1, 2, 0, 1]
    gw = [0, 2, 3, 5, 7, 8, 9, 11, 12, 14]
    for args in ((answers, [3, 4], starts, indexes, zooms, gw, 8),
                 (answers, [12, 13, 14], starts, indexes, zooms, list(range(30)), 8)):
        assert TM.stage2_window_hit(*args) == JM.stage2_window_hit(*args)
    for nv in (8, [8, 8, 8, 4, 4]):
        assert TM.stage2_chosen_windows(answers, starts, indexes, zooms, calls, gw, nv) == \
            JM.stage2_chosen_windows(answers, starts, indexes, zooms, calls, gw, nv)

    def logs():
        g = [{"video_id": "m", "task": "grounding", "query_id": f"q{i}",
              "answer": ["From 1 to 2.", "Not Present", "From 3 to 9", "From 0 to 4"],
              "info": {"iou": [0.8, 0.1, 0.4], "scores": [0.9, 0.2, 0.5]}} for i in range(3)]
        r = [{"video_id": "m", "task": "grounding", "query_id": f"q{i}",
              "answer": ["In video 1", "From 0 to 2"],
              "info": {"frames": {"0": [0, 3 + i], "1": [4, 7]}, "mean_entropy": [0.5, 0.25]}}
             for i in range(2)]
        r2 = [{"video_id": "m", "task": "grounding", "query_id": "q0", "answer": ["In video 5"],
               "info": {"frames": {"0": [5, 9]}}}]
        return g, r, r2

    for kw in ({}, {"buffer": 1}, {"single": False}, {"buffer": -1}):
        for second in (False, True):
            jg, jr, jr2 = logs()
            tg, tr, tr2 = logs()
            want = JM.fuse_retrieval_grounding(jg, jr, jr2 if second else None, **kw)
            got = TM.fuse_retrieval_grounding(tg, tr, tr2 if second else None, **kw)
            assert got == want, kw
    fused, _ = TM.fuse_retrieval_grounding(*logs()[:2])
    assert TM.grounding_metrics_stream(fused) == JM.grounding_metrics_stream(fused)
    assert TM.grounding_metrics_simple(fused) == JM.grounding_metrics_simple(fused)
    assert TM.min_max_normalize([3.0, 1.0, 2.0]) == JM.min_max_normalize([3.0, 1.0, 2.0])


def test_cli_helpers_and_loader_configs_match_jax():
    for v in ("True", "false", "1", "no", True, ""):
        assert str2bool(v) == jstr2bool(v)
    with pytest.raises(argparse.ArgumentTypeError):
        str2bool("maybe")
    argv = ["--data_path", "d.json", "--feat_folder", "f", "--log_path", "l"]
    for tmod, jmod, extra in ((tstage1, jstage1, ["--batch", "64", "--clip_adapter", "True",
                                                  "--clip_adapter_text", "True"]),
                              (tstage2, jstage2, ["--zooms", "4,1", "--stride", "3"])):
        targs, jargs = tmod.parse_args(argv + extra), jmod.parse_args(argv + extra)
        assert targs.device is None   # the port's own flag: CUDA unless told otherwise
        assert {k: v for k, v in vars(targs).items() if k != "device"} == vars(jargs)
        assert tloader.adapter_cfg_from_args(targs).__dict__ == \
            jloader.adapter_cfg_from_args(jargs).__dict__
        assert tloader.eval_cfg_from_args(targs).__dict__ == \
            jloader.eval_cfg_from_args(jargs).__dict__
    fargv = ["--grounding_path", "g", "--retrieval_path", "r", "--buffers", "0", "2"]
    assert vars(tfusion.parse_args(fargv)) == vars(jfusion.parse_args(fargv))


def test_prefetch_map_matches_jax():
    items = list(range(7))
    assert list(tprefetch.prefetch_map(lambda x: x * x, items)) == \
        list(jprefetch.prefetch_map(lambda x: x * x, items))

    def boom(x):
        if x == 3:
            raise KeyError(x)
        return x

    with pytest.raises(KeyError):
        list(tprefetch.prefetch_map(boom, items))


# ---------------------------------------------------------------- the model


@pytest.mark.parametrize("with_text", [True, False])
def test_hierarchy_encode_video_matches_jax(with_text, monkeypatch):
    """[B, V, T, d] -> [B, V, hidden]: each row's query features repeated in
    place for its V windows (ragged masks tell a tiled repeat apart), in
    adapter slices of 4 windows here (HIERARCHY_CHUNK): 1e-5 in f32."""
    monkeypatch.setattr(trl, "HIERARCHY_CHUNK", 4)
    kw = adapter_kw(32, True)
    jv = jrl.init_vision_params(JAdapter(**kw), jax.random.PRNGKey(3), d_in=16)
    rng = np.random.default_rng(4)
    images = rng.normal(size=(3, 5, 10, 16)).astype(np.float32)
    text = rng.normal(size=(3, 4, 16)).astype(np.float32) if with_text else None
    tvalid = np.asarray([[1, 1, 1, 1], [1, 1, 0, 0], [1, 0, 0, 0]], bool) if with_text else None
    want = jrl.encode_video(JAdapter(**kw), jv, jnp.asarray(images),
                            None if text is None else jnp.asarray(text),
                            None if tvalid is None else jnp.asarray(tvalid))
    got = trl.encode_video(TAdapter(**kw), to_torch(jv), torch.from_numpy(images),
                           None if text is None else torch.from_numpy(text),
                           None if tvalid is None else torch.from_numpy(tvalid))
    assert got.shape == want.shape == (3, 5, 32)
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shared_prefix", ["0", "1"])
def test_retrieve_matches_jax(s2_engines, movie, queries, shared_prefix, monkeypatch):
    """retrieve over every window and over a prefiltered subset, with the
    shared-prefix switch off and on (the rows of a stage-2 call share one
    plan, so the switch takes prefill_shared_prefix on both sides)."""
    monkeypatch.setenv("REVISIONLLM_SHARED_PREFIX", shared_prefix)
    jeng, teng = s2_engines
    _warm(s2_engines, queries, "retrieval")
    # 400 frames: 19 windows, 8 passes; a 64-frame movie: 7 windows, fewer
    # than a pass holds, so parsed answers map inside it and get cosines
    short = movie[:64].copy()
    for q, feats, gw in zip(queries * 2, (movie, movie, short, short),
                            (None, [0, 2, 3, 5, 7, 8], None, [1, 2, 5])):
        want = jeng.retrieve(feats, q["sentence"], q["query_feats"], q["query_cls"],
                             grounding_windows=gw, rng=np.random.default_rng(11))
        got = teng.retrieve(feats, q["sentence"], q["query_feats"], q["query_cls"],
                            grounding_windows=gw, rng=np.random.default_rng(11))
        _assert_retrieve_equal(want, got)
        if feats is short:
            assert len(got["score_cos"]) > 0


def test_shared_prefix_len_follows_the_switch(s2_engines, monkeypatch):
    """The engine's switch: 0 unless REVISIONLLM_SHARED_PREFIX=1; then the
    first video slot of identical plans, 0 for a single row or rows whose
    plans differ (a multi-query chunk), as in the JAX engine."""
    from revisionllm_tpu_torch.models.multimodal import build_splice_plan, stack_plans

    jeng, teng = s2_engines
    a = build_splice_plan(teng._prompt_ids("a red car", QUESTIONS["retrieval"]), 8, 80)
    b = build_splice_plan(teng._prompt_ids("a blue car", QUESTIONS["retrieval"]), 8, 80)
    plans = {"same": stack_plans([a] * 3), "one": stack_plans([a]), "mixed": stack_plans([a, b])}
    monkeypatch.delenv("REVISIONLLM_SHARED_PREFIX", raising=False)
    assert all(TEngine._shared_prefix_len(p) == 0 for p in plans.values())
    monkeypatch.setenv("REVISIONLLM_SHARED_PREFIX", "1")
    for name, p in plans.items():
        assert TEngine._shared_prefix_len(p) == JEngine._shared_prefix_len(p), name
    assert TEngine._shared_prefix_len(plans["same"]) > 1


@pytest.mark.parametrize("buckets", [None, "3"])
def test_retrieve_batch_matches_jax(s2_engines, movie, queries, buckets, monkeypatch):
    """retrieve_batch (the passes of both queries as rows of shared calls,
    the query features picked per row by qsel) against JAX's, and against
    the port's own per-query retrieve; with a 3-row bucket the passes split
    across calls."""
    if buckets:
        monkeypatch.setenv("REVISIONLLM_S2_ROW_BUCKETS", buckets)
    jeng, teng = s2_engines
    _warm(s2_engines, queries, "retrieval")
    gws = [None, [0, 2, 3, 5, 7, 8]]
    batch = [{**q, "grounding_windows": gw, "rng": np.random.default_rng(7)}
             for q, gw in zip(queries, gws)]
    want = jeng.retrieve_batch(movie, batch)
    got = teng.retrieve_batch(movie, [{**q, "rng": np.random.default_rng(7)} for q in batch],
                              movie_key="m")
    assert len(got) == len(want) == 2
    for w, g in zip(want, got):
        _assert_retrieve_equal(w, g)
    singles = [teng.retrieve(movie, q["sentence"], q["query_feats"], q["query_cls"],
                             grounding_windows=gw, rng=np.random.default_rng(7), movie_key="m")
               for q, gw in zip(queries, gws)]
    for s, g in zip(singles, got):
        _assert_retrieve_equal(s, g)
    with pytest.raises(ValueError):
        teng.retrieve_batch(movie, [queries[0], {"sentence": "x"}])
    assert teng.retrieve_batch(movie, []) == []


@pytest.mark.parametrize("shared_prefix", ["0", "1"])
def test_ground_windows_batch_matches_jax(movie, queries, shared_prefix, monkeypatch):
    """ground_windows_batch (rows of both queries packed into chunks of 4,
    per-row plans, qsel) against JAX's and against the port's own
    per-query ground_windows; chunks that hold one query's rows take the
    shared prefix when it is on."""
    monkeypatch.setenv("REVISIONLLM_SHARED_PREFIX", shared_prefix)
    pair = engines(False, S1_EVAL, kv_heads=2)
    jeng, teng = pair
    _warm(pair, queries, "mad_grounding")
    want = jeng.ground_windows_batch(movie, queries)
    got = teng.ground_windows_batch(movie, queries, movie_key="m")
    singles = [teng.ground_windows(movie, q["sentence"], q["query_feats"], q["query_cls"],
                                   movie_key="m") for q in queries]
    for w, g, s in zip(want, got, singles):
        assert g["num_windows"] == 19
        assert_stage1_equal(w, g)
        assert_stage1_equal(s, g)
    bare = [{"sentence": q["sentence"]} for q in queries]
    assert [g["answers"] for g in teng.ground_windows_batch(movie, bare)] == \
        [w["answers"] for w in jeng.ground_windows_batch(movie, bare)]
    with pytest.raises(ValueError):
        teng.ground_windows_batch(movie, [queries[0], {"sentence": "x"}])


class _RowRecorder:
    """Stands in for the engine's device call: records each call's index
    shape and answers "Not Present" for every row."""

    def __init__(self, eng):
        self.calls = []
        eng._run_chunk = self.run
        eng._read_chunk = self.read

    def run(self, plan_np, rows, feats_dev, qf, qv, n_live):
        self.calls.append(tuple(np.asarray(rows).shape))
        return len(rows)

    def read(self, n):
        return ["Not Present"] * n, np.ones((n, 4), np.float32)


@pytest.mark.parametrize("buckets,want_calls", [
    (None, [(7, 8, 16)]),                           # 5 passes padded to the 7-row bucket
    ("5,10", [(5, 8, 16)]),                         # an exact bucket, no padding
    ("2", [(2, 8, 16), (2, 8, 16), (2, 8, 16)]),    # groups of the largest bucket
])
def test_stage2_row_buckets(buckets, want_calls, monkeypatch):
    """As tests/test_e2e_pipeline.py:379-445: a 75-frame track gives 9
    windows, zooms (2, 1) over batch 8 give 5 passes of 8 window rows."""
    if buckets:
        monkeypatch.setenv("REVISIONLLM_S2_ROW_BUCKETS", buckets)
    _, teng = engines(True, S2_EVAL)
    rec = _RowRecorder(teng)
    res = teng.retrieve(np.zeros((75, 16), np.float32), "a query")
    assert rec.calls == want_calls
    assert len(res["answers"]) == 5 and res["hierarchy_zooms"] == [2, 2, 2, 1, 1]


# ------------------------------------------------------------------ the CLIs


@pytest.fixture(scope="module")
def eval_data(tmp_path_factory):
    """A 200 s movie at 2 fps (400 frames) with two queries, and their
    token and CLS features."""
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(0)
    np.save(root / "m1.npy", rng.normal(size=(400, 16)).astype(np.float32))
    data = {
        "q1": {"movie": "m1", "movie_duration": 200.0, "timestamps": [50.0, 60.0],
               "query": "a red car drives by."},
        "q2": {"movie": "m1", "movie_duration": 200.0, "timestamps": [100.0, 110.0],
               "query": "someone opens a door?"},
    }
    with open(root / "val.json", "w") as f:
        json.dump(data, f)
    qdir = root / "qfeats"
    qdir.mkdir()
    for qid in data:
        np.savez(qdir / f"{qid}.npz", token_features=rng.normal(size=(5, 16)).astype(np.float32),
                 cls_features=rng.normal(size=(16,)).astype(np.float32))
    return root


@pytest.mark.parametrize("query_batch", [1, 2])
def test_stage1_stage2_fusion_clis_match_jax(eval_data, tmp_path, query_batch, capsys):
    """stage1.run -> stage2.run --grounding_path (that log) -> fusion.main on
    both packages' engines: the same JSONL records (scores, entropies and
    cosines within rtol 1e-4) and the same fused metrics. query_batch 2
    takes ground_windows_batch and retrieve_batch."""
    s1 = engines(False, S1_EVAL)
    s2 = engines(True, S2_EVAL)
    common = dict(data_path=str(eval_data / "val.json"), feat_folder=str(eval_data),
                  q_feat_dir=str(eval_data / "qfeats"), debug_window=20, num_frames=16,
                  feature_fps=2.0, split=0, total_split=1, debug=True, query_batch=query_batch)
    metrics = []
    for side, (eng1, eng2, st1, st2, fus) in enumerate((
            (s1[0], s2[0], jstage1, jstage2, jfusion), (s1[1], s2[1], tstage1, tstage2, tfusion))):
        out = tmp_path / str(side)
        a1 = argparse.Namespace(**common, log_path=str(out / "s1"), batch=4, score="mean_entropy",
                                score_merge="multiply", normalize=True, topk_pool=True,
                                skip_small_videos=True, mad_prompt="mad_grounding",
                                max_new_tokens=6)
        r1 = st1.run(a1, eng1)
        assert r1["done"] == 2 and r1["errors"] == 0
        a2 = argparse.Namespace(**common, log_path=str(out / "s2"), grounding_path=str(out / "s1"),
                                batch=8, stride=5, distributed_retrieval=1, single=True,
                                max_new_tokens=4, seed=42)
        r2 = st2.run(a2, eng2)
        assert r2["done"] == 2 and r2["errors"] == 0
        metrics.append(fus.main(["--grounding_path", str(out / "s1"), "--retrieval_path",
                                 str(out / "s2"), "--distributed_grounding", "1",
                                 "--distributed_retrieval", "1"]))
    assert_records_equal(records(tmp_path / "0" / "s1"), records(tmp_path / "1" / "s1"),
                          {"scores"})
    assert_records_equal(records(tmp_path / "0" / "s2"), records(tmp_path / "1" / "s2"),
                          {"score_cos", "mean_entropy", "max_entropy"})
    assert metrics[1].keys() == metrics[0].keys()
    for k in metrics[0]:
        assert metrics[1][k] == pytest.approx(metrics[0][k], rel=1e-6), k
    with open(tmp_path / "1" / "s1" / "result_retrieval.txt") as f:
        assert json.load(f) == pytest.approx(metrics[1])
