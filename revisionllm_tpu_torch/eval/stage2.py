"""Stage-2 hierarchical retrieval eval CLI, ported from
revisionllm_tpu/eval/stage2.py.

`main` builds the engine (a hierarchy `cls` adapter) from an HF checkpoint
directory (eval/loader.py) on --device, CUDA by default, and calls
`run(args, engine)`, which also takes an engine built in Python.

Flag + output parity with reference revisionllm/eval/eval_nlq_retrieval_e2e2.py:
GT seconds -> window-id conversion, strided window slicing, optional
pre-filtering by a previous grounding run's log (--grounding_path), the
multi-scale zoom loop with window shuffling, inverse-entropy confidences, and
the same JSONL record schema.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time as _time
from typing import Dict, List

import numpy as np

from revisionllm_tpu_torch.data.feature_store import QueryFeatureStore, open_feature_store
from revisionllm_tpu_torch.data.prefetcher import prefetch_map
from revisionllm_tpu_torch.eval import metrics as M
from revisionllm_tpu_torch.eval.engine import GroundingEngine
from revisionllm_tpu_torch.eval.loader import build_engine_from_args
from revisionllm_tpu_torch.eval.stage1 import load_items
from revisionllm_tpu_torch.ops.windows import get_ground_truth_windows, num_windows_strided
from revisionllm_tpu_torch.parallel.launch import is_main_process
from revisionllm_tpu_torch.utils.cli import str2bool


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="stage-2 hierarchical retrieval eval")
    p.add_argument("--model_base", type=str, required=False)
    p.add_argument("--pretrain_clip_adapter", type=str, default=None)
    p.add_argument("--stage2", type=str, default=None)
    p.add_argument("--stage3", type=str, default=None)
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--feat_folder", type=str, required=True)
    p.add_argument("--q_feat_dir", type=str, default=None)
    p.add_argument("--log_path", type=str, required=True)
    p.add_argument("--grounding_path", type=str, default=None)
    p.add_argument("--task", type=str, default="grounding")
    p.add_argument("--debug_window", type=int, default=125)
    p.add_argument("--num_frames", type=int, default=250)
    p.add_argument("--feature_fps", type=float, default=5)
    p.add_argument("--batch", type=int, default=100)
    p.add_argument("--stride", type=int, default=5)
    p.add_argument("--split", type=int, default=0)
    p.add_argument("--total_split", type=int, default=1)
    p.add_argument("--distributed_retrieval", type=int, default=16)
    p.add_argument("--single", type=str2bool, default=True)
    p.add_argument("--clip_adapter", type=str2bool, default=True)
    p.add_argument("--clip_adapter_text", type=str2bool, default=True)
    p.add_argument("--hierarchy", type=str2bool, default=True)
    # adapter geometry (reference hard-codes 768/8/2/2048 in
    # adapter/transformer.py:77-85; flags allow small-model integration runs)
    p.add_argument("--adapter_d_model", type=int, default=768)
    p.add_argument("--adapter_heads", type=int, default=8)
    p.add_argument("--adapter_layers", type=int, default=2)
    p.add_argument("--adapter_ffn", type=int, default=2048)
    p.add_argument("--max_new_tokens", type=int, default=32)
    p.add_argument("--retrieval_prompt", type=str, default="retrieval",
                   help="QUESTIONS key for the retrieval question (the "
                        "reference hard-codes 'retrieval' at "
                        "eval_nlq_retrieval_e2e2.py:329)")
    p.add_argument("--zooms", type=str, default="4,2,1",
                   help="comma list of hierarchy zoom scales per multi-scale "
                        "pass (reference eval_nlq_retrieval_e2e2.py:337)")
    p.add_argument("--mesh", type=str, default=None,
                   help="dp,fsdp,tp: serve across the ranks torchrun starts (rank 0 "
                        "writes the predictions)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--query_batch", type=int, default=1,
                   help="row-stack N same-movie queries' zoom passes into "
                        "shared bucket-shaped programs (throughput mode)")
    p.add_argument("--debug", type=str2bool, default=False)
    p.add_argument("--device", type=str, default=None,
                   help="default cuda (raises without a GPU); cpu to run on the CPU")
    return p.parse_args(argv)


def grounding_prefilter(
    grounding_log: dict, num_windows: int, stride: int, batch: int
) -> List[int]:
    """Windows to keep, from a stage-1 log (parity:
    eval_nlq_retrieval_e2e2.py:278-294)."""
    gw0 = [i for i, a in enumerate(grounding_log["answer"]) if a != "Not Present"]
    windows: List[int] = []
    for i in gw0:
        windows.extend(
            range(
                math.floor((i - 1) * (stride / 2)),
                math.ceil((i - 1) * (stride / 2) + (stride / 2)),
            )
        )
    windows = sorted(set(w for w in windows if 0 <= w < num_windows))
    if batch > len(windows):
        non = [i for i in range(num_windows) if i not in windows]
        if non:
            stridex = max(int(len(non) / max(batch - len(windows), 1)), 1)
            windows = sorted(windows + non[::stridex][: batch - len(windows)])
    return windows


def run(args, engine: GroundingEngine) -> Dict[str, int]:
    os.makedirs(args.log_path, exist_ok=True)
    prediction_path = os.path.join(
        args.log_path, f"predictions_streaming_{args.split}.txt"
    )
    done = set()
    if os.path.exists(prediction_path):
        with open(prediction_path) as f:
            for line in f:
                try:
                    done.add(json.loads(line)["query_id"])
                except Exception:
                    pass

    vis_store = open_feature_store(args.feat_folder)
    q_store = QueryFeatureStore(args.q_feat_dir) if args.q_feat_dir else None

    items = load_items(args.data_path)
    # GT seconds -> coarse window ids (parity :215-219)
    for qid, item in items:
        item["clip_id"] = qid
        item["timestamps"], item["duration"] = get_ground_truth_windows(
            item["timestamps"][0], item["timestamps"][1], item["movie_duration"]
        )

    binsize = len(items) // args.total_split
    if args.split == args.total_split - 1:
        items = items[args.split * binsize :]
    else:
        items = items[args.split * binsize : (args.split + 1) * binsize]

    grounding_dict = {}
    if args.grounding_path is not None:
        for gl in M.load_prediction_logs(args.grounding_path, args.distributed_retrieval):
            grounding_dict[gl["query_id"]] = gl

    rng = np.random.default_rng(args.seed)
    items = [(qid, data) for qid, data in items if qid not in done]

    def _load(item):
        """Per-query host IO one query ahead (see stage1._load)."""
        qid, data = item
        try:
            movie = data.get("movie", data.get("clip_id", qid))
            features = vis_store.get(movie)
            qf = qc = None
            if q_store is not None:
                qf, qc = q_store.get(qid)
            return qid, data, movie, features, qf, qc, None
        except Exception as e:  # noqa: BLE001
            return qid, data, None, None, None, None, e

    errors, n_done = [], 0
    latencies = []
    qbatch = max(int(getattr(args, "query_batch", 1) or 1), 1)

    def _finalize(qid, movie, data, res, t0):
        nonlocal n_done
        frames, ious = M.stage2_window_hit(
            res["answers"], data["timestamps"], res["starts"], res["indexes"],
            res["hierarchy_zooms"], res["grounding_windows"], args.batch,
        )
        if is_main_process():
            M.write_log(
                prediction_path, movie, "grounding", qid, res["answers"],
                info={
                    "gt": data["timestamps"],
                    "frames": frames,
                    "iou": ious,
                    "score_cos": res["score_cos"],
                    "mean_entropy": res["mean_entropy"],
                    "max_entropy": res["max_entropy"],
                    "hierarchy_zooms": res["hierarchy_zooms"],
                },
            )
        n_done += 1
        latencies.append(_time.time() - t0)

    # --query_batch N: row-stack N same-movie queries' zoom passes into as
    # few bucket-shaped programs as fit (engine.retrieve_batch). The shared
    # rng generator is passed to every query IN ORDER, so the permutation
    # stream matches the sequential path exactly.
    group: List[tuple] = []

    def _flush():
        if not group:
            return
        movie = group[0][2]
        features = group[0][3]
        qkey = getattr(args, "retrieval_prompt", "retrieval")
        try:
            if len(group) == 1:
                g = group[0]
                res_list = [engine.retrieve(
                    features, g[6], g[4], g[5], grounding_windows=g[7],
                    rng=rng, question_key=qkey, movie_key=movie,
                )]
            else:
                res_list = engine.retrieve_batch(
                    features,
                    [{"sentence": g[6], "query_feats": g[4],
                      "query_cls": g[5], "grounding_windows": g[7],
                      "rng": rng} for g in group],
                    question_key=qkey, movie_key=movie,
                )
            for g, res in zip(group, res_list):
                _finalize(g[0], g[2], g[1], res, g[8])
        except Exception:
            if args.debug:
                raise
            errors.extend(g[0] for g in group)
        finally:
            group.clear()

    for qid, data, movie, features, query_feats, query_cls, load_err in (
        prefetch_map(_load, items)
    ):
        _t0 = _time.time()
        try:
            if load_err is not None:
                raise load_err
            if "movie_duration" in data and data["movie_duration"] <= args.debug_window:
                continue

            sentence = (
                data["sentence"].strip().lower()
                if "sentence" in data
                else data["query"].strip(".?").lower()
            )
            if "sentence" in data and sentence.endswith("."):
                sentence = sentence[:-1]

            gw = None
            if qid in grounding_dict:
                clip_length = int(args.debug_window * args.feature_fps)
                nw = num_windows_strided(len(features), clip_length, args.stride)
                gw = grounding_prefilter(grounding_dict[qid], nw, args.stride, args.batch)

            if group and (
                group[0][2] != movie
                or (group[0][4] is None) != (query_feats is None)
            ):
                _flush()
            group.append((qid, data, movie, features, query_feats,
                          query_cls, sentence, gw, _t0))
            if len(group) >= qbatch:
                _flush()
        except Exception:
            if args.debug:
                raise
            errors.append(qid)
    _flush()
    print("errors", errors, file=sys.stderr)
    stats = {"done": n_done, "errors": len(errors)}
    if latencies:
        lat = np.sort(np.asarray(latencies))
        stats["p50_latency_s"] = float(lat[len(lat) // 2])
        stats["p95_latency_s"] = float(lat[int(len(lat) * 0.95)])
        stats["queries_per_sec"] = float(len(lat) / lat.sum())
        print(
            f"{'stage2'}: p50 {stats['p50_latency_s']:.2f}s "
            f"p95 {stats['p95_latency_s']:.2f}s "
            f"{stats['queries_per_sec']:.3f} q/s",
            file=sys.stderr,
        )
    return stats


def main(argv=None):
    args = parse_args(argv)
    engine = build_engine_from_args(args)
    run(args, engine)


if __name__ == "__main__":
    main()
