"""Dataset sanity checks and statistics: a host copy of
revisionllm_tpu/data/analysis.py over the port's feature stores.

Covers the roles of the reference helper scripts
(revisionllm/data/vidchap7m/check.py — verify every record's feature file
exists and is long enough; analysis.py — duration/GT-length statistics;
reformat_video_id.py — id normalization), as one CLI:

  python -m revisionllm_tpu_torch.data.analysis stats   --data_path recs.json
  python -m revisionllm_tpu_torch.data.analysis check   --data_path recs.json --feat_folder store
  python -m revisionllm_tpu_torch.data.analysis reformat --data_path recs.json --out_path fixed.json
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

import numpy as np


def load_records(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        out = []
        for qid, v in data.items():
            v = dict(v)
            v.setdefault("query_id", qid)
            out.append(v)
        return out
    return data


def stats(records: List[dict]) -> Dict[str, float]:
    durations, gt_lens = [], []
    movies: Dict[str, int] = {}
    for r in records:
        meta = r.get("meta", {})
        if "duration" in meta:
            durations.append(float(meta["duration"]))
        tok = meta.get("token", {})
        if "<s0>" in tok and "<e0>" in tok:
            gt_lens.append(float(tok["<e0>"]) - float(tok["<s0>"]))
        movies[r.get("id", "?")] = movies.get(r.get("id", "?"), 0) + 1
    out = {"num_records": len(records), "num_videos": len(movies)}
    if durations:
        d = np.asarray(durations)
        out.update(
            duration_min=float(d.min()), duration_max=float(d.max()),
            duration_mean=float(d.mean()), duration_median=float(np.median(d)),
        )
    if gt_lens:
        g = np.asarray(gt_lens)
        out.update(
            gt_len_min=float(g.min()), gt_len_max=float(g.max()),
            gt_len_mean=float(g.mean()), gt_len_median=float(np.median(g)),
        )
    return out


def check(records: List[dict], feat_folder: str, num_frames: int = 0) -> Dict[str, list]:
    """Verify each record's feature track exists and is long enough
    (parity role: vidchap7m/check.py)."""
    from revisionllm_tpu_torch.data.feature_store import open_feature_store

    store = open_feature_store(feat_folder)
    missing, short = [], []
    seen = set()
    for r in records:
        vid = r.get("id")
        if vid in seen:
            continue
        seen.add(vid)
        if vid not in store:
            missing.append(vid)
            continue
        if num_frames:
            try:
                feats = store.get(vid)
                if feats.shape[0] < num_frames:
                    short.append(vid)
            except Exception:
                missing.append(vid)
    return {"missing": missing, "too_short": short, "checked": len(seen)}


def reformat_ids(records: List[dict]) -> List[dict]:
    """Normalize video ids (strip extensions/path bits — the role of
    reformat_video_id.py)."""
    for r in records:
        vid = str(r.get("id", ""))
        vid = vid.rsplit("/", 1)[-1]
        for ext in (".mp4", ".mkv", ".webm", ".npy"):
            if vid.endswith(ext):
                vid = vid[: -len(ext)]
        r["id"] = vid
    return records


def main(argv=None):
    p = argparse.ArgumentParser(description="dataset sanity / statistics")
    p.add_argument("cmd", choices=["stats", "check", "reformat"])
    p.add_argument("--data_path", required=True)
    p.add_argument("--feat_folder", default=None)
    p.add_argument("--num_frames", type=int, default=0)
    p.add_argument("--out_path", default=None)
    args = p.parse_args(argv)

    records = load_records(args.data_path)
    if args.cmd == "stats":
        print(json.dumps(stats(records), indent=2))
    elif args.cmd == "check":
        if not args.feat_folder:
            sys.exit("--feat_folder required for check")
        result = check(records, args.feat_folder, args.num_frames)
        print(json.dumps({k: (v if isinstance(v, int) else v[:20]) for k, v in result.items()}, indent=2))
        print(f"missing={len(result['missing'])} too_short={len(result['too_short'])}", file=sys.stderr)
    else:
        records = reformat_ids(records)
        out = args.out_path or args.data_path
        with open(out, "w") as f:
            json.dump(records, f)
        print(f"wrote {len(records)} records to {out}")


if __name__ == "__main__":
    main()
