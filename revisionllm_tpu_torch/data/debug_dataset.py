"""Dataset smoke-harness, a host copy of revisionllm_tpu/data/debug_dataset.py
over the port's dataset and collator (parity: reference
train/debug_dataset.py:12-32): iterate the dataset through the collator to
surface data bugs; with --strict any per-item failure raises instead of
resampling."""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def debug(dataset, collator, batch_size: int = 4, limit: int = 0) -> dict:
    n = 0
    t0 = time.time()
    shapes = set()
    total = limit or len(dataset)
    for start in range(0, total, batch_size):
        items = [dataset[i % len(dataset)] for i in range(start, min(start + batch_size, total))]
        batch = collator(items)
        shapes.add(tuple(batch["images"].shape[1:]))
        n += len(items)
    dt = time.time() - t0
    return {"items": n, "sec": dt, "items_per_sec": n / max(dt, 1e-9), "image_shapes": sorted(shapes)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", required=True)
    p.add_argument("--feat_folder", required=True)
    p.add_argument("--q_feat_dir", default=None)
    p.add_argument("--model_base", default=None)
    p.add_argument("--preset", default="stage1_dense")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--limit", type=int, default=64)
    p.add_argument("--strict", action="store_true")
    args = p.parse_args(argv)

    from revisionllm_tpu_torch.config import DataConfig, get_preset
    from revisionllm_tpu_torch.data.collator import Collator
    from revisionllm_tpu_torch.data.dataset import GroundingDataset

    wl = get_preset(args.preset)
    cfg = DataConfig(**{
        **wl.data.__dict__, "data_path": args.data_path,
        "feat_folder": args.feat_folder, "q_feat_dir": args.q_feat_dir,
    })
    if args.model_base:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.model_base, use_fast=True)
    else:
        from revisionllm_tpu_torch.utils.testing import FakeTokenizer

        tokenizer = FakeTokenizer()
    ds = GroundingDataset(
        args.data_path, tokenizer, cfg, rng=np.random.default_rng(0),
        debug=args.strict,
    )
    coll = Collator(max_len=2048, num_video_tokens=0)
    stats = debug(ds, coll, args.batch_size, args.limit)
    print(stats, file=sys.stderr)


if __name__ == "__main__":
    main()
