"""Fusion + final metrics CLI, a copy of revisionllm_tpu/eval/fusion.py (it
runs no model).

    python -m revisionllm_tpu_torch.eval.fusion --grounding_path G --retrieval_path R

Parity with reference revisionllm/eval/metric_retrieval_forward.py __main__:
load sharded grounding + retrieval (+optional second retrieval) logs, fuse
(eval/metrics.fuse_retrieval_grounding), print the selected/total ratio and
`R{1,5,10,50}@IoU{0.1..0.9}` + mIoU, write result_retrieval.txt.

Also covers the VidChapters variant (metric_retrieval_forward_chapters.py)
via --buffers sweeping.
"""

from __future__ import annotations

import argparse
import json
import os

from revisionllm_tpu_torch.eval import metrics as M
from revisionllm_tpu_torch.utils.cli import str2bool


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="retrieval->grounding fusion metrics")
    p.add_argument("--grounding_path", type=str, required=True)
    p.add_argument("--retrieval_path", type=str, required=True)
    p.add_argument("--retrieval_path2", type=str, default=None)
    p.add_argument("--task", type=str, default="grounding")
    p.add_argument("--stream", type=str2bool, default=True)
    p.add_argument("--distributed_grounding", type=int, default=16)
    p.add_argument("--distributed_retrieval", type=int, default=16)
    p.add_argument("--single", type=str2bool, default=True)
    p.add_argument("--buffers", type=int, nargs="*", default=[0])
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    grounding_logs = M.load_prediction_logs(args.grounding_path, args.distributed_grounding)
    retrieval_logs = M.load_prediction_logs(args.retrieval_path, args.distributed_retrieval)
    retrieval_logs2 = (
        M.load_prediction_logs(args.retrieval_path2, args.distributed_retrieval)
        if args.retrieval_path2
        else None
    )

    metrics = {}
    for buffer in args.buffers:
        print("buffer:", buffer)
        fused, ratio = M.fuse_retrieval_grounding(
            grounding_logs, retrieval_logs, retrieval_logs2,
            buffer=buffer, single=args.single,
        )
        print(args.grounding_path)
        print(ratio)
        print("====================== Grounding ======================")
        if args.stream:
            metrics = M.grounding_metrics_stream(fused)
        else:
            metrics = M.grounding_metrics_simple(fused)
        for k, v in metrics.items():
            print(f"{k}: {v:.2f}")

    with open(os.path.join(args.grounding_path, "result_retrieval.txt"), "w+") as f:
        json.dump(metrics, f)
    return metrics


if __name__ == "__main__":
    main()
