"""MSRVTT text->video retrieval eval CLI, in PyTorch.

Counterpart of revisionllm_tpu/eval/msrvtt.py, which completes the
reference's `revisionllm/data/retrieval/msrvtt/` family: the
converter (`data/converters.py::msrvtt_to_records`) and the t2v TRAINING
path (`DataConfig.t2v`, dataset.py:657-693) existed; the reference never
shipped a working eval for it (its README comments the MSRVTT rows out,
README.md:75-89). This CLI is the eval-side counterpart built from the same
machinery the stage-2 retrieval eval uses: each query ranks the candidate
corpus via hierarchy passes of `--batch` video-CLS tokens, the LLM answers
'In video N' (the t2v training answer, dataset.py:676), winners are scored
by inverse decode entropy (x query-CLS cosine when --q_feat_dir is given).

Inputs:
  --data_path   MSRVTT_JSFUSION_test.csv (video_id, sentence columns) or a
                JSON dict {qid: {"video": ..., "sentence": ...}}
  --feat_folder npy dir / RVFS store of per-video CLIP feature tracks

Metrics: R@1/5/10 + MedR over the candidate set, written to
<log_path>/result_t2v.json; per-query JSONL for resume, like the other CLIs.
Runs on CUDA unless --device says otherwise:

    python -m revisionllm_tpu_torch.eval.msrvtt --model_base hf/ --stage2 s2/ \\
        --data_path MSRVTT_JSFUSION_test.csv --feat_folder feats/ \\
        --log_path logs/t2v [--q_feat_dir qfeats/] [--device cpu]
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
from typing import Dict, List

import numpy as np

from revisionllm_tpu_torch.data.feature_store import QueryFeatureStore, open_feature_store
from revisionllm_tpu_torch.eval import metrics as M
from revisionllm_tpu_torch.parallel.launch import barrier, is_main_process
from revisionllm_tpu_torch.utils.cli import str2bool


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="MSRVTT text->video retrieval eval")
    p.add_argument("--model_base", type=str, required=False)
    p.add_argument("--pretrain_clip_adapter", type=str, default=None)
    p.add_argument("--stage2", type=str, default=None)
    p.add_argument("--stage3", type=str, default=None)
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--feat_folder", type=str, required=True)
    p.add_argument("--q_feat_dir", type=str, default=None)
    p.add_argument("--log_path", type=str, required=True)
    p.add_argument("--num_frames", type=int, default=100)
    p.add_argument("--batch", type=int, default=100)
    p.add_argument("--split", type=int, default=0)
    p.add_argument("--total_split", type=int, default=1)
    p.add_argument("--clip_adapter", type=str2bool, default=True)
    p.add_argument("--clip_adapter_text", type=str2bool, default=True)
    p.add_argument("--hierarchy", type=str2bool, default=True)
    p.add_argument("--adapter_d_model", type=int, default=768)
    p.add_argument("--adapter_heads", type=int, default=8)
    p.add_argument("--adapter_layers", type=int, default=2)
    p.add_argument("--adapter_ffn", type=int, default=2048)
    p.add_argument("--max_new_tokens", type=int, default=8)
    p.add_argument("--retrieval_prompt", type=str, default="retrieval")
    p.add_argument("--mesh", type=str, default=None,
                   help="dp,fsdp,tp: serve across the ranks torchrun starts (rank 0 "
                        "writes the predictions)")
    p.add_argument("--debug", type=str2bool, default=False)
    # engine knobs the loader reads
    p.add_argument("--debug_window", type=int, default=0)
    p.add_argument("--feature_fps", type=float, default=1.0)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--device", type=str, default=None,
                   help="default cuda (raises without a GPU); cpu for a smoke run")
    return p.parse_args(argv)


def load_queries(data_path: str) -> List[dict]:
    if data_path.endswith(".csv"):
        with open(data_path) as f:
            rows = list(csv.DictReader(f))
        return [
            {"query_id": r.get("key", r["video_id"] + f"_{i}"),
             "video": r["video_id"], "sentence": r["sentence"]}
            for i, r in enumerate(rows)
        ]
    with open(data_path) as f:
        js = json.load(f)
    return [
        {"query_id": qid, "video": v["video"], "sentence": v["sentence"]}
        for qid, v in js.items()
    ]


def run(args, engine) -> Dict[str, float]:
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

    queries = load_queries(args.data_path)
    # candidate corpus = every distinct video in the query list, in first-
    # appearance order (the JSFUSION 1k-candidate protocol)
    corpus: List[str] = list(dict.fromkeys(q["video"] for q in queries))
    cand_index = {v: i for i, v in enumerate(corpus)}

    vis_store = open_feature_store(args.feat_folder)
    q_store = QueryFeatureStore(args.q_feat_dir) if args.q_feat_dir else None

    def sample_track(vid: str) -> np.ndarray:
        feats = vis_store.get(vid)
        idx = np.linspace(0, feats.shape[0] - 1, args.num_frames, dtype=np.int32)
        return feats[idx]

    stack = np.stack([sample_track(v) for v in corpus], axis=0)  # [V, T, d]

    binsize = len(queries) // args.total_split
    if args.split == args.total_split - 1:
        queries = queries[args.split * binsize :]
    else:
        queries = queries[args.split * binsize : (args.split + 1) * binsize]

    errors, ranks = [], []
    for q in queries:
        if q["query_id"] in done:
            continue
        try:
            sentence = q["sentence"].strip().lower()
            if sentence.endswith("."):
                sentence = sentence[:-1]
            qf = qc = None
            if q_store is not None:
                qf, qc = q_store.get(str(q["query_id"]))
            res = engine.retrieve_videos(
                stack, sentence, qf, qc,
                question_key=args.retrieval_prompt,
                corpus_key=("t2v_corpus", args.data_path, args.feat_folder),
            )
            gt = cand_index[q["video"]]
            rank = res["ranked"].index(gt) + 1 if gt in res["ranked"] else len(corpus)
            ranks.append(rank)
            if is_main_process():
                M.write_log(
                    prediction_path, q["video"], "retrieval", q["query_id"],
                    res["answers"],
                    info={"ranked": res["ranked"], "scores": res["scores"],
                          "gt": gt, "rank": rank},
                )
        except Exception:
            if args.debug:
                raise
            errors.append(q["query_id"])

    print("errors", errors, file=sys.stderr)
    barrier()  # rank 0 has written every record before any rank reads them
    logs = M.load_prediction_logs(args.log_path, args.total_split)
    all_ranks = [l["info"]["rank"] for l in logs if "rank" in l.get("info", {})]
    metrics: Dict[str, float] = {}
    if all_ranks:
        r = np.asarray(all_ranks)
        metrics = {
            "R@1": float((r <= 1).mean() * 100),
            "R@5": float((r <= 5).mean() * 100),
            "R@10": float((r <= 10).mean() * 100),
            "MedR": float(np.median(r)),
            "n": int(len(r)),
        }
        if is_main_process():
            with open(os.path.join(args.log_path, "result_t2v.json"), "w") as f:
                json.dump(metrics, f, indent=2)
            print(json.dumps(metrics))
    return metrics


def main(argv=None):
    args = parse_args(argv)
    from revisionllm_tpu_torch.eval.loader import build_engine_from_args

    engine = build_engine_from_args(args)
    return run(args, engine)


if __name__ == "__main__":
    main()
