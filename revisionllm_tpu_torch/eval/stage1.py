"""Stage-1 dense grounding eval CLI, ported from revisionllm_tpu/eval/stage1.py.

`main` builds the engine from an HF checkpoint directory (--model_base,
--stage2, ...; eval/loader.py) on --device, CUDA by default, and calls
`run(args, engine)`, which also takes an engine built in Python:

    python -m revisionllm_tpu_torch.eval.stage1 --model_base vicuna/ \
        --stage2 stage1_out/ --data_path val.json --feat_folder feats/ \
        --log_path logs/ [--device cpu]

Flag + output parity with reference revisionllm/eval/eval_nlq_negative.py:
iterates the query list (with --split/--total_split sharding and resume by
replaying the existing prediction log), grounds every window of each movie
through the batched engine, scores proposals by inverse entropy x CLIP
cosine, and appends the same JSONL records so
metric_retrieval_forward-compatible fusion runs unchanged.
"""

from __future__ import annotations

import argparse
import json
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
from revisionllm_tpu_torch.parallel.launch import is_main_process
from revisionllm_tpu_torch.utils.cli import str2bool


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="stage-1 dense grounding eval")
    p.add_argument("--model_base", type=str, required=False)
    p.add_argument("--pretrain_mm_mlp_adapter", type=str, default=None)
    p.add_argument("--pretrain_clip_adapter", type=str, default=None)
    p.add_argument("--stage2", type=str, default=None)
    p.add_argument("--stage3", type=str, default=None)
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--feat_folder", type=str, required=True)
    p.add_argument("--q_feat_dir", type=str, default=None)
    p.add_argument("--log_path", type=str, required=True)
    p.add_argument("--task", type=str, default="grounding")
    p.add_argument("--debug_window", type=int, default=125)
    p.add_argument("--num_frames", type=int, default=250)
    p.add_argument("--feature_fps", type=float, default=5)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--split", type=int, default=0)
    p.add_argument("--total_split", type=int, default=1)
    p.add_argument("--score", type=str, default="mean_entropy",
                   choices=["cosine_sim", "max_entropy", "mean_entropy"])
    p.add_argument("--score_merge", type=str, default="multiply", choices=["add", "multiply"])
    p.add_argument("--normalize", type=str2bool, default=True)
    p.add_argument("--topk_pool", type=str2bool, default=True)
    p.add_argument("--skip_small_videos", type=str2bool, default=True)
    p.add_argument("--clip_adapter", type=str2bool, default=False)
    p.add_argument("--clip_adapter_text", type=str2bool, default=False)
    p.add_argument("--hierarchy", type=str2bool, default=False)
    p.add_argument("--mad_prompt", type=str, default="mad_grounding")
    # adapter geometry (reference hard-codes 768/8/2/2048 in
    # adapter/transformer.py:77-85; flags allow small-model integration runs)
    p.add_argument("--adapter_d_model", type=int, default=768)
    p.add_argument("--adapter_heads", type=int, default=8)
    p.add_argument("--adapter_layers", type=int, default=2)
    p.add_argument("--adapter_ffn", type=int, default=2048)
    p.add_argument("--mesh", type=str, default=None,
                   help="dp,fsdp,tp: serve across the ranks torchrun starts (rank 0 "
                        "writes the predictions)")
    p.add_argument("--max_new_tokens", type=int, default=32)
    p.add_argument("--baseline", type=str2bool, default=False)
    p.add_argument("--plus_baseline", type=str2bool, default=False)
    p.add_argument("--query_batch", type=int, default=1,
                   help="batch N same-movie queries into shared device "
                        "chunks (throughput mode; the reference's version "
                        "is a 16-way job array, eval_nlq_negative.py:179)")
    p.add_argument("--debug", type=str2bool, default=False)
    p.add_argument("--device", type=str, default=None,
                   help="default cuda (raises without a GPU); cpu to run on the CPU")
    return p.parse_args(argv)


def load_items(data_path: str) -> List[tuple]:
    """(parity: eval_nlq_negative.py:167-177 input format sniffing)."""
    if "jsonl" in data_path:
        with open(data_path) as f:
            js = [json.loads(line) for line in f]
        return [(k["query_id"], k) for k in js]
    js = json.load(open(data_path))
    if "videos" in js:
        return [(k["query"], k) for k in js["videos"]]
    return list(js.items())


def run(args, engine: GroundingEngine) -> Dict[str, int]:
    os.makedirs(args.log_path, exist_ok=True)
    prediction_path = os.path.join(
        args.log_path, f"predictions_streaming_{args.split}.txt"
    )

    done = set()
    if os.path.exists(prediction_path):  # resume (parity :157-165)
        with open(prediction_path) as f:
            for line in f:
                try:
                    done.add(json.loads(line)["query_id"])
                except Exception:
                    pass

    vis_store = open_feature_store(args.feat_folder)
    q_store = QueryFeatureStore(args.q_feat_dir) if args.q_feat_dir else None

    items = load_items(args.data_path)
    binsize = len(items) // args.total_split
    if args.split == args.total_split - 1:
        items = items[args.split * binsize :]
    else:
        items = items[args.split * binsize : (args.split + 1) * binsize]

    items = [(qid, data) for qid, data in items if qid not in done]

    def _load(item):
        """Heavy per-query host IO (feature track + query feats), run one
        query AHEAD of the device in a background thread — the cross-query
        half of the pipeline (the in-query chunk pipeline is in the engine).
        Per-item errors are captured, not raised: the resume-on-error
        semantics (reference eval_nlq_negative.py:334-341) must survive."""
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
        """Per-query scoring + log write (reference eval_nlq_negative.py
        :281-341)."""
        nonlocal n_done
        duration = data.get("movie_duration", data.get("duration"))
        timestamps = data["timestamps"]
        gt = (timestamps[0] / duration, timestamps[1] / duration)
        num_frames_video = int(duration * args.num_frames / args.debug_window)
        # res["scores"] is already per-PROPOSAL (the engine replicates
        # the reference's parse -> cosine -> normalize -> merge chain,
        # eval_nlq_negative.py:281-336), in ascending-window order —
        # the same order stage1_iou emits ious. Passing it back through
        # stage1_iou's per-window filtering would mis-index (it expects
        # one score per WINDOW, reference :291-298).
        _, ious, _ = M.stage1_iou(
            res["answers"], gt, args.num_frames, num_frames_video,
            [], getattr(args, "plus_baseline", False),
        )
        if is_main_process():
            M.write_log(
                prediction_path, movie, "grounding", qid, res["answers"],
                info={"iou": ious, "scores": res["scores"]},
            )
        n_done += 1
        latencies.append(_time.time() - t0)

    # --query_batch N: group same-movie queries into shared chunks
    # (engine.ground_windows_batch — the throughput mode; the reference's
    # equivalent is a 16-way job array, eval_nlq_negative.py:179-180)
    group: List[tuple] = []

    def _flush():
        nonlocal n_done
        if not group:
            return
        movie = group[0][2]
        features = group[0][3]
        try:
            if len(group) == 1:
                qid, data, _, feats, qf, qc, sentence, t0 = group[0]
                res_list = [engine.ground_windows(
                    feats, sentence, qf, qc,
                    question_key=args.mad_prompt, movie_key=movie,
                )]
            else:
                res_list = engine.ground_windows_batch(
                    features,
                    [{"sentence": g[6], "query_feats": g[4], "query_cls": g[5]}
                     for g in group],
                    question_key=args.mad_prompt, movie_key=movie,
                )
            for g, res in zip(group, res_list):
                _finalize(g[0], g[2], g[1], res, g[7])
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

            if (
                "movie_duration" in data
                and data["movie_duration"] <= args.debug_window
                and args.skip_small_videos
            ):
                continue

            if getattr(args, "task", "grounding") in ("captioning", "all"):
                # dense captioning per window (reference eval_nlq_negative.py:265-268)
                _flush()
                cap_res = engine.caption_windows(features, movie_key=movie)
                if is_main_process():
                    M.write_log(prediction_path, movie, "captioning", qid, cap_res["answers"])
                if getattr(args, "task", "grounding") == "captioning":
                    n_done += 1
                    continue

            sentence = (
                data["sentence"].strip().lower()
                if "sentence" in data
                else data["query"].strip(".?").lower()
            )
            if "sentence" in data and sentence.endswith("."):
                sentence = sentence[:-1]

            # flush on movie change or qf-presence change (batches must be
            # same-movie and qf-uniform)
            if group and (
                group[0][2] != movie
                or (group[0][4] is None) != (query_feats is None)
            ):
                _flush()
            group.append((qid, data, movie, features, query_feats,
                          query_cls, sentence, _t0))
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
            f"{'stage1'}: p50 {stats['p50_latency_s']:.2f}s "
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
