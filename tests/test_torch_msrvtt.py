"""Port parity for MSR-VTT-style text-to-video retrieval:
GroundingEngine.retrieve_videos with _map_retrieval_answers
(revisionllm_tpu_torch/eval/engine.py) and the eval/msrvtt.py CLI against
the JAX package's on one tiny f32 tree (a hierarchy cls ClipEncoder, JAX's
weights carried across) and one feature store: the same answers and
rankings, scores within rtol 1e-5, the same prediction lines (scores within
rtol 1e-5) and metrics, resume included; and the copied eval/window_recall.py
and eval/merge_results.py against their originals."""

import json
import os

import numpy as np
import pytest
import torch

from revisionllm_tpu.eval import engine as jengine
from revisionllm_tpu.eval import merge_results as jmerge
from revisionllm_tpu.eval import msrvtt as jmsrvtt
from revisionllm_tpu.eval import window_recall as jwr
from revisionllm_tpu_torch.eval import engine as tengine
from revisionllm_tpu_torch.eval import merge_results as tmerge
from revisionllm_tpu_torch.eval import msrvtt as tmsrvtt
from revisionllm_tpu_torch.eval import window_recall as twr

from torch_parity import engines

torch.set_num_threads(2)
T2V_EVAL = dict(debug_window=20, num_frames=8, feature_fps=2.0, batch=3, stride=2,
                max_new_tokens=6)
SCORE_TOL = dict(rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("args,want", [
    # V 5, batch 3: passes start at 0 and 2; candidate 2 chosen twice keeps
    # its better score
    ((["In video 2.", "In video 0."], [1.0, 4.0], [0, 2], 3, 5), ([2], [4.0])),
    # V 2 < batch 3: an answer at the padded slot maps to the candidate it
    # repeats
    ((["In video 2."], [2.5], [0], 3, 2), ([1], [2.5])),
    ((["nope"], [1.0], [0], 3, 5), ([], [])),
    ((["In video 1", "In video 9", "In video 0"], [3.0, 2.0, 5.0], [0, 3, 4], 3, 7),
     ([1, 5, 4], [3.0, 2.0, 5.0])),
], ids=["dedup", "padded_slot", "unparsed", "clamped_tail"])
def test_map_retrieval_answers_matches_jax(args, want):
    assert tengine._map_retrieval_answers(*args) == jengine._map_retrieval_answers(*args) == want


@pytest.fixture(scope="module")
def engs():
    return engines(hierarchy=True, ecfg_kw=T2V_EVAL)


@pytest.mark.parametrize("V,with_query", [(7, True), (7, False), (2, True)],
                         ids=["tail_pass", "no_query_features", "fewer_than_a_batch"])
def test_retrieve_videos_matches_jax(engs, V, with_query):
    """Passes of 3 candidates over a corpus of V (the tail pass from V - 3,
    or one padded pass), with and without query features and CLS."""
    jeng, teng = engs
    rng = np.random.default_rng(V)
    corpus = rng.normal(size=(V, 8, 16)).astype(np.float32)
    qf = rng.normal(size=(5, 16)).astype(np.float32) if with_query else None
    qc = rng.normal(size=(16,)).astype(np.float32) if with_query else None
    want = jeng.retrieve_videos(corpus, "a red car", qf, qc, corpus_key=("c", V))
    got = teng.retrieve_videos(corpus, "a red car", qf, qc, corpus_key=("c", V))
    assert got["answers"] == want["answers"] and len(got["answers"]) == -(-V // 3)
    assert got["ranked"] == want["ranked"] and got["num_candidates"] == V
    np.testing.assert_allclose(got["scores"], want["scores"], **SCORE_TOL)
    assert all(0 <= c < V for c in got["ranked"])


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """tests/test_msrvtt_eval.py's world: 6 videos of 40 frames x 16, one
    query each, query-token and CLS features, as a JSON query file."""
    root = tmp_path_factory.mktemp("t2v")
    rng = np.random.default_rng(0)
    (root / "feats").mkdir()
    (root / "queries").mkdir()
    queries = {}
    for i in range(6):
        np.save(root / "feats" / f"video{i}.npy", rng.normal(size=(40, 16)).astype(np.float32))
        queries[f"q{i}"] = {"video": f"video{i}", "sentence": f"Pattern {i}."}
        np.savez(root / "queries" / f"q{i}.npz",
                 token_features=rng.normal(size=(4, 16)).astype(np.float32),
                 cls_features=rng.normal(size=(16,)).astype(np.float32))
    with open(root / "queries.json", "w") as f:
        json.dump(queries, f)
    return root


def _lines(log):
    with open(os.path.join(log, "predictions_streaming_0.txt")) as f:
        return [json.loads(line) for line in f]


def _run(mod, engine, store, log, extra=()):
    args = mod.parse_args(["--data_path", str(store / "queries.json"), "--feat_folder",
                           str(store / "feats"), "--q_feat_dir", str(store / "queries"),
                           "--log_path", str(log), "--num_frames", "8", "--batch", "3",
                           "--max_new_tokens", "6", "--debug", "True", *extra])
    return mod.run(args, engine)


def test_msrvtt_run_matches_jax_with_resume(engs, store, tmp_path):
    """msrvtt.run on both sides: the same prediction lines and metrics;
    then the port resumes a log cut after two queries and ends with the same
    lines, and a finished log is left as it is."""
    jeng, teng = engs
    want_m = _run(jmsrvtt, jeng, store, tmp_path / "jax")
    got_m = _run(tmsrvtt, teng, store, tmp_path / "port")
    want, got = _lines(tmp_path / "jax"), _lines(tmp_path / "port")
    assert len(got) == len(want) == 6
    for w, g in zip(want, got):
        assert {k: v for k, v in g.items() if k != "info"} == \
            {k: v for k, v in w.items() if k != "info"}
        assert {k: v for k, v in g["info"].items() if k != "scores"} == \
            {k: v for k, v in w["info"].items() if k != "scores"}
        np.testing.assert_allclose(g["info"]["scores"], w["info"]["scores"], **SCORE_TOL)
    assert got_m == want_m and got_m["n"] == 6
    with open(tmp_path / "port" / "result_t2v.json") as f:
        assert json.load(f) == want_m

    path = tmp_path / "port" / "predictions_streaming_0.txt"
    full = path.read_text()
    path.write_text("".join(full.splitlines(keepends=True)[:2]))
    assert _run(tmsrvtt, teng, store, tmp_path / "port") == got_m
    assert _lines(tmp_path / "port") == got
    resumed = path.read_text()
    _run(tmsrvtt, teng, store, tmp_path / "port")
    assert path.read_text() == resumed


def test_msrvtt_parse_args_match_jax():
    argv = ["--data_path", "q.csv", "--feat_folder", "f", "--log_path", "l"]
    want = vars(jmsrvtt.parse_args(argv))
    got = vars(tmsrvtt.parse_args(argv + ["--device", "cpu"]))
    assert got.pop("device") == "cpu" and got == want


def test_load_queries_matches_jax(tmp_path):
    csv_path = tmp_path / "q.csv"
    csv_path.write_text("key,video_id,sentence\nk0,video7,a man cooks\n,video8,two dogs\n")
    json_path = tmp_path / "q.json"
    json_path.write_text(json.dumps({"a": {"video": "v1", "sentence": "s"}}))
    for p in (csv_path, json_path):
        assert tmsrvtt.load_queries(str(p)) == jmsrvtt.load_queries(str(p))


def test_window_recall_matches_jax():
    gt = [{"query_id": "a", "timestamps": [10.0, 30.0]},
          {"query_id": "b", "timestamps": [400.0, 410.0]},
          {"query_id": "c", "timestamps": [0.0, 5.0]}]
    pred = {"a": [5, 0, 1], "b": [9, 8, 4, 3, 2], "c": [7]}
    for kw in ({}, {"topk": (1, 2), "clip_length": 1.0, "max_v_l": 100},
               {"match_number": False}):
        assert twr.window_selection_recall(pred, gt, **kw) == \
            jwr.window_selection_recall(pred, gt, **kw)
    assert twr.ground_truth_window_ids((10.0, 30.0), 0.2, 900) == \
        jwr.ground_truth_window_ids((10.0, 30.0), 0.2, 900)
    with pytest.raises(ValueError):
        twr.window_selection_recall({"a": [1]}, gt)


def test_merge_results_matches_jax(tmp_path, capsys):
    rng = np.random.default_rng(1)
    for split in range(2):
        with open(tmp_path / f"predictions_streaming_{split}.txt", "w") as f:
            for i in range(5):
                info = {"iou": [float(rng.uniform())], "fn": int(i % 2), "fp": int(i % 3 == 0)}
                f.write(json.dumps({"video": "m", "task": "grounding", "query_id": f"{split}{i}",
                                    "answer": [], "info": info}) + "\n")
    argv = ["--log_path", str(tmp_path), "--total_split", "2"]
    want = jmerge.main(argv)
    want_out = capsys.readouterr().out
    assert tmerge.main(argv) == want and want["fp"] > 0
    assert capsys.readouterr().out == want_out
