"""Merge sharded prediction logs and print simple per-answer metrics.

A copy of revisionllm_tpu/eval/merge_results.py.

Parity role: `calculate_result` (reference eval_nlq_negative.py:344-368 /
eval_nlq_retrieval_e2e2.py:424-448): read every shard's log, report mIoU +
R1@{0.1,0.3,0.5,0.7} and the fn/fp rates when present. For the score-ranked
fusion metrics use eval/fusion.py instead.
"""

from __future__ import annotations

import argparse
import json

from revisionllm_tpu_torch.eval import metrics as M


def main(argv=None):
    p = argparse.ArgumentParser(description="merge shard logs + simple metrics")
    p.add_argument("--log_path", required=True)
    p.add_argument("--total_split", type=int, default=16)
    args = p.parse_args(argv)

    logs = M.load_prediction_logs(args.log_path, args.total_split)
    grounding = [l for l in logs if l.get("task") == "grounding"]
    print(f"Found {len(grounding)} grounding logs")
    metrics = M.grounding_metrics_simple(grounding)

    fn = [l["info"]["fn"] for l in grounding if "fn" in l.get("info", {})]
    fp = [l["info"]["fp"] for l in grounding if "fp" in l.get("info", {})]
    if fp:
        metrics["fn"] = sum(fn) / max(len(fp) // 2, 1) * 100
        metrics["fp"] = sum(fp) / max(len(fp) // 2, 1) * 100

    for k, v in metrics.items():
        print(f"{k}: {v:.2f}")
    return metrics


if __name__ == "__main__":
    main()
