"""Batch collation: dataset items -> static-shape device batches. A host
copy of revisionllm_tpu/data/collator.py over the port's models/multimodal.py.

Replaces the reference DataCollatorForSupervisedDataset
(revisionllm/train/dataset.py:399-451): instead of padding raw input_ids for
a dynamic splice on device, each item's sentinel-carrying ids become a
`SplicePlan` (models/multimodal.py) and the batch is a dict of fixed-shape
int32/float arrays. The mutable `iteration_step` counter that drives the
'alternate' adapter mode (:405-413) is carried explicitly.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from revisionllm_tpu_torch.models.multimodal import build_splice_plan, stack_plans


class Collator:
    def __init__(
        self,
        max_len: int,
        num_video_tokens: int,
        num_memory_tokens: int = 0,
        max_q_len: int = 25,
    ):
        self.max_len = max_len
        self.num_video_tokens = num_video_tokens
        self.num_memory_tokens = num_memory_tokens
        self.max_q_len = max_q_len
        self.iteration_step = 0

    def __call__(self, items: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        batch = self.collate(items)
        if "clip2" in items[0]:
            batch["clip2"] = self.collate([it["clip2"] for it in items])
            batch["clip2"]["neg"] = np.asarray(
                [it["clip2"]["neg"] for it in items], np.int32
            )
        if "neg" in items[0]:
            batch["neg"] = np.asarray([it["neg"] for it in items], np.int32)
        batch["iteration_step"] = self.iteration_step
        self.iteration_step += 1
        return batch

    def collate(self, items: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        plans = [
            build_splice_plan(
                it["input_ids"],
                num_video_tokens=self._video_tokens_for(it),
                max_len=self.max_len,
                labels=it["labels"],
                num_memory_tokens=self.num_memory_tokens,
            )
            for it in items
        ]
        batch: Dict[str, np.ndarray] = dict(stack_plans(plans))
        batch["images"] = np.stack([np.asarray(it["image"], np.float32) for it in items])

        if "query_feat" in items[0]:
            L = self.max_q_len
            d = items[0]["query_feat"].shape[-1]
            qf = np.zeros((len(items), L, d), np.float32)
            qv = np.zeros((len(items), L), bool)
            for b, it in enumerate(items):
                q = np.asarray(it["query_feat"], np.float32)[:L]
                qf[b, : len(q)] = q
                qv[b, : len(q)] = True
            batch["query_feats"] = qf
            batch["query_valid"] = qv
        if "start_end_frame" in items[0]:
            batch["start_end_frame"] = np.asarray(
                [it.get("start_end_frame", [0, 0]) for it in items], np.int32
            )
        return batch

    def _video_tokens_for(self, item: Dict[str, Any]) -> int:
        img = np.asarray(item["image"])
        if img.ndim == 3:   # hierarchy: [V, T, d] -> V CLS tokens
            return img.shape[0]
        if self.num_video_tokens > 0:
            return self.num_video_tokens
        return img.shape[0]  # temporal: one token per frame
