"""Supervised grounding dataset (host-side, numpy only). A host copy of
revisionllm_tpu/data/dataset.py, so that the port never imports the JAX
package.

Rebuild of the reference LazySupervisedDataset
(revisionllm/train/dataset.py:453-866) over the unified "activitynet-style"
conversation records:
  {id, query_id?, conversations: [human: '<video>\n During which frames...',
   gpt: 'From <s0> to <e0>.'], meta: {duration, token: {<s0>, <e0>}}, source}

Behavioral parity (all randomness through one np.random.Generator so runs are
reproducible — the reference sprinkles global random.* calls):
- negative-sample synthesis: rewrite answers to 'Not Present'/'no', duplicate
  data by neg_samples/neg_factor (dataset.py:481-501)
- per-item window crop: random offset window of debug_window seconds around
  the GT, negative-window resampling away from the GT, fps renormalization
  for stage2 (x100/duration) and short VidChapters clips (x2)
  (dataset.py:727-797)
- timestamp -> two-digit frame token substitution via ops.windows.
  timestamp_to_frame_token (dataset.py:805-832)
- hierarchy batch assembly: 2-3 positive consecutive windows + temporally
  disjoint negative windows, sorted by start, answer 'From i to j'
  (dataset.py:563-623), with zoom repetition (hierarchy_zoom)
- stream mode: paired clips for memory training (dataset.py:625-637)
- fault tolerance: any per-item failure resamples a random item
  (dataset.py:834-841) unless debug mode raises
"""

from __future__ import annotations

import copy
import json
import math
import re
from typing import Any, Dict, List, Optional

import numpy as np

from revisionllm_tpu_torch.config import DataConfig
from revisionllm_tpu_torch.constants import NEGATIVE_ANSWER, NEGATIVE_ANSWER_RETRIEVAL
from revisionllm_tpu_torch.data.feature_store import QueryFeatureStore, open_feature_store
from revisionllm_tpu_torch.data.preprocess import preprocess_v1
from revisionllm_tpu_torch.ops.windows import timestamp_to_frame_token

SPAN_RE = re.compile(r"(\d+) (to|and) (\d+)")


class GroundingDataset:
    def __init__(
        self,
        data_path: str,
        tokenizer,
        cfg: DataConfig,
        rng: Optional[np.random.Generator] = None,
        model_max_length: int = 2048,
        debug: bool = False,
    ):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.rng = rng or np.random.default_rng(42)
        self.model_max_length = model_max_length
        self.debug = debug

        with open(data_path) as f:
            self.records: List[dict] = json.load(f)

        if cfg.sparse_length > 0:
            self.records = [
                r for r in self.records if r["meta"]["duration"] > cfg.sparse_length
            ]
        if cfg.sparse_dataset:
            by_id: Dict[str, List[dict]] = {}
            for r in self.records:
                by_id.setdefault(r["id"], []).append(r)
            self.records = [
                group[self.rng.integers(len(group))] for group in by_id.values()
            ]

        self.t2v: Optional[List[str]] = None
        if cfg.t2v is not None:
            # MSRVTT retrieval: list of candidate video ids (reference
            # dataset.py:476-480 reads the csv's video_id column)
            import csv

            with open(cfg.t2v) as f:
                self.t2v = [row["video_id"] for row in csv.DictReader(f)]

        self.neg_value = NEGATIVE_ANSWER_RETRIEVAL if cfg.retrieval_only else NEGATIVE_ANSWER
        if cfg.neg_window:
            if cfg.retrieval_only and self.t2v is None:
                for r in self.records:
                    q = r["conversations"][0]["value"]
                    q = q.replace("<video>\nDuring which frames can we see ", "")[:-1]
                    r["conversations"][0]["value"] = (
                        "<video>\nDoes {} happen in the video? "
                        "Write your answer either yes or no.".format(q)
                    )
                    r["conversations"][1]["value"] = "yes"
            if cfg.neg_samples > 1:
                for r in self.records[:: int(cfg.neg_samples)]:
                    r["conversations"][1]["value"] = self.neg_value
            else:
                neg_list = []
                for r in self.records[:: int(1 / cfg.neg_samples)]:
                    neg = copy.deepcopy(r)
                    neg["conversations"][1]["value"] = self.neg_value
                    neg_list.append(neg)
                for _ in range(cfg.neg_factor):
                    self.records = self.records + neg_list

        self._vis_store = None
        self._query_store = None
        self._cache: Dict[str, np.ndarray] = {}
        # 'alternate' schedule: even steps -> hierarchy CLS batches, odd steps
        # -> plain temporal batches (reference dataset.py:564-567). Set by the
        # training loop each step.
        self.iteration_step = 0

    # ------------------------------------------------------------------ io

    def _vis(self, vid: str) -> np.ndarray:
        if self._vis_store is None:
            self._vis_store = open_feature_store(self.cfg.feat_folder)
        if vid not in self._cache:
            self._cache[vid] = self._vis_store.get(vid)
        return self._cache[vid]

    def _query(self, qid: str):
        if self._query_store is None:
            self._query_store = QueryFeatureStore(self.cfg.q_feat_dir)
        return self._query_store.get(str(qid))

    def __len__(self) -> int:
        return len(self.records)

    # -------------------------------------------------------------- getitem

    def __getitem__(self, i: int) -> Dict[str, Any]:
        cfg = self.cfg
        if self.t2v is not None:
            try:
                return self._t2v_item(i)
            except Exception:
                if self.debug:
                    raise
                return self[int(self.rng.integers(len(self)))]
        if cfg.hierarchy:
            if (
                cfg.clip_adapter_feature == "alternate"
                and self.iteration_step % 2 == 1
            ):
                return self.getitem(i)
            try:
                return self._hierarchy_item(i)
            except Exception:
                if self.debug:
                    raise
                return self[int(self.rng.integers(len(self)))]
        if cfg.stream:
            toss1 = int(self.rng.integers(2))
            toss2 = int(self.rng.integers(2))
            clip1 = self.getitem(i, neg=toss1 == 0)
            clip2 = self.getitem(i, neg=toss2 == 0, clip2=True)
            if clip2 is None:
                return self[int(self.rng.integers(len(self)))]
            clip1["clip2"] = clip2
            return clip1
        return self.getitem(i)

    def _t2v_item(self, i: int) -> Dict[str, Any]:
        """MSRVTT text->video retrieval sampling (reference dataset.py:657-693):
        whole OTHER videos serve as negatives; positives answer 'In video N'
        (hierarchy) or draw a random video for the 'no' answer (flat)."""
        cfg = self.cfg
        source = copy.deepcopy(self.records[i])
        is_neg = source["conversations"][1]["value"] == self.neg_value

        def sample_track(vid):
            feats = self._vis(vid)
            idx = np.linspace(0, feats.shape[0] - 1, cfg.num_frames, dtype=np.int32)
            return feats[idx]

        others = [x for x in self.t2v if x != source["id"]]
        if cfg.hierarchy:
            num_videos = cfg.hierarchy_num_videos - (0 if is_neg else 1)
            neg_ids = list(self.rng.choice(others, size=num_videos, replace=False))
            neg_images = [sample_track(n) for n in neg_ids]
            if is_neg:
                source["conversations"][1]["value"] = NEGATIVE_ANSWER
                image = np.stack(neg_images, axis=0)
            else:
                pos_idx = int(self.rng.integers(0, cfg.hierarchy_num_videos))
                source["conversations"][1]["value"] = f"In video {pos_idx}"
                pos = sample_track(source["id"])
                image = np.stack(
                    neg_images[:pos_idx] + [pos] + neg_images[pos_idx:], axis=0
                )
        else:
            vid = source["id"]
            if is_neg:
                vid = str(self.rng.choice(others))
            image = sample_track(vid)

        query_feat = query_cls = None
        if cfg.q_feat_dir is not None and "query_id" in source:
            query_feat, query_cls = self._query(str(source["query_id"]))

        processed = preprocess_v1(
            source["conversations"], self.tokenizer, self.model_max_length,
            ignore_temporal=cfg.ignore_temporal,
        )
        out: Dict[str, Any] = {
            "input_ids": processed["input_ids"],
            "labels": processed["labels"],
            "image": np.asarray(image),
            "hier_neg_start": 0,
        }
        if query_feat is not None:
            out["query_feat"] = query_feat
            out["query_cls"] = query_cls
        return out

    def _hierarchy_item(self, i: int) -> Dict[str, Any]:
        """Assemble one hierarchy sample: positive windows + disjoint negatives
        (reference dataset.py:563-623)."""
        cfg = self.cfg
        source = copy.deepcopy(self.records[i])
        num_pos = int(self.rng.integers(*cfg.hierarchy_pos_range))
        if cfg.hierarchy_zoom:
            zoom = cfg.fix_hierarchy_zoom if cfg.fix_hierarchy_zoom > 0 else int(
                self.rng.choice([1, 2])
            )
        else:
            zoom = 1
        is_neg = source["conversations"][1]["value"] == self.neg_value
        if is_neg and cfg.hierarchy_neg:
            num_neg = cfg.hierarchy_num_videos // zoom
        else:
            num_neg = cfg.hierarchy_num_videos // zoom - num_pos

        gt_s = source["meta"]["token"]["<s0>"]
        gt_e = source["meta"]["token"]["<e0>"]
        starts: List[float] = []
        neg_images: List[np.ndarray] = []
        attempts = 0
        while len(starts) < num_neg:
            attempts += 1
            if attempts > 50 * max(num_neg, 1):
                raise RuntimeError("cannot mine enough disjoint negative windows")
            neg_data = self.getitem(i, neg=True)
            start_frame = neg_data["hier_neg_start"]
            start_sec = start_frame / cfg.feature_fps
            if gt_e < start_sec or gt_s > start_sec + cfg.debug_window:
                neg_images.append(neg_data["image"])
                starts.append(start_frame)

        order = np.argsort(np.asarray(starts))
        neg_images = [neg_images[j] for j in order]

        if is_neg and cfg.hierarchy_neg:
            pos_data = neg_data
            image = np.stack(neg_images, axis=0)
            out = pos_data
        else:
            pos_idx = int(self.rng.integers(0, cfg.hierarchy_num_videos // zoom - num_pos + 1))
            if zoom > 1:
                conv_value = f"From {zoom * pos_idx} to {zoom * (pos_idx + num_pos - 1) + 1}."
            elif cfg.hierarchy_zoom:
                conv_value = f"From {pos_idx} to {pos_idx + num_pos - 1}."
            else:
                conv_value = f"From {pos_idx} to {pos_idx + num_pos}."
            pos_items = [self.getitem(i, conv_value=conv_value) for _ in range(num_pos)]
            image = [pd["image"] for pd in pos_items]
            image = neg_images[:pos_idx] + image + neg_images[pos_idx:]
            image = [w for w in image for _ in range(zoom)]
            image = np.stack(image, axis=0)
            out = pos_items[0]
        out["image"] = image
        return out

    def getitem(
        self,
        i: int,
        neg: bool = False,
        clip2: bool = False,
        conv_value: Optional[str] = None,
    ) -> Optional[Dict[str, Any]]:
        cfg = self.cfg
        try:
            return self._getitem_inner(i, neg, clip2, conv_value)
        except Exception:
            if self.debug:
                raise
            if clip2:
                return None
            return self.getitem(int(self.rng.integers(len(self))), neg=neg)

    def _getitem_inner(self, i, neg, clip2, conv_value):
        cfg = self.cfg
        source = copy.deepcopy(self.records[i])

        if "<image>" in source["conversations"][0]["value"]:
            source["conversations"][0]["value"] = source["conversations"][0][
                "value"
            ].replace("<image>", "<video>")

        if clip2:
            source["conversations"][0]["value"] += "\n<memory>"

        query_feat = query_cls = None
        if cfg.q_feat_dir is not None and "query_id" in source:
            query_feat, query_cls = self._query(source["query_id"])

        image = self._vis(source["id"])
        if image.shape[0] < cfg.num_frames or image.ndim == 1:
            raise ValueError("feature track too short")

        meta = source["meta"]
        meta_start = meta["token"]["<s0>"]
        meta_end = meta["token"]["<e0>"]
        fps = cfg.feature_fps
        duration = meta["duration"]
        change_fps = False

        if (
            source.get("source") == "vidchapters7m"
            and duration < 2 * cfg.debug_window
            and cfg.feature_fps == 2
        ):
            change_fps = True
            meta_start *= 2
            meta_end *= 2
            fps *= 2
            duration *= 2
        if source.get("source") == "stage2" or cfg.long_baseline:
            fps = 1
            meta_start *= 100 / duration
            meta_end *= 100 / duration
            duration = 100

        is_neg_answer = source["conversations"][1]["value"] == self.neg_value
        if (
            cfg.debug_window <= math.ceil(meta_end - meta_start)
            and source.get("source") == "stage2"
            and is_neg_answer
        ):
            raise ValueError("stage2 negative with GT longer than window")

        # negative window: move the crop away from the GT (dataset.py:753-764)
        if is_neg_answer or neg:
            if meta_start > cfg.debug_window + 1:
                toss = int(self.rng.integers(2))
                if (
                    toss == 0
                    and meta_end < math.floor(duration) - cfg.debug_window - 2
                    and not neg
                ):
                    meta_start = int(
                        self.rng.integers(
                            math.ceil(meta_end) + 1,
                            math.floor(duration - cfg.debug_window - 1) + 1,
                        )
                    )
                else:
                    meta_start = int(
                        self.rng.integers(0, math.floor(meta_start) - cfg.debug_window)
                    )
            else:
                meta_start = int(
                    self.rng.integers(
                        math.ceil(meta_end) + 1,
                        math.floor(duration - cfg.debug_window - 1) + 1,
                    )
                )
            meta_end = meta_start + 1

        gt_len = math.ceil(meta_end - meta_start)
        if cfg.debug_window <= gt_len and source.get("source") != "stage2":
            if cfg.keep_longer_gt:
                if int(self.rng.integers(2)) == 0:
                    meta["token"]["<e0>"] = meta_start + cfg.debug_window - 1
                    meta_end = meta["token"]["<e0>"]
                else:
                    meta["token"]["<s0>"] = meta_end - cfg.debug_window + 1
                    meta_start = meta["token"]["<s0>"]
                gt_len = math.ceil(meta_end - meta_start)
            else:
                raise ValueError("GT longer than window")

        # random crop of debug_window seconds containing the GT (:778-794)
        start_s = 0.0
        if cfg.debug_window != 0:
            offset = int(self.rng.integers(0, max(cfg.debug_window - gt_len, 1)))
            start_s = max(0, meta_start - offset)
            end_s = start_s + cfg.debug_window
            start, end = round(start_s * fps), round(end_s * fps)
            if end > image.shape[0] - 1:
                end = image.shape[0] - 1
                start = max(0, end - round(cfg.debug_window * fps))
                start_s = start / fps
        else:
            start, end = 0, image.shape[0] - 1

        if (
            cfg.debug_window <= gt_len
            and source.get("source") == "stage2"
            and not is_neg_answer
        ):
            start, end = 0, image.shape[0] - 1

        if image.shape[0] > cfg.num_frames:
            sampled = np.linspace(start, end, cfg.num_frames, dtype=np.int32)
            image = image[sampled]

        # timestamp -> frame-index token substitution (:805-832)
        if conv_value is not None:
            source["conversations"][1]["value"] = conv_value
            m = SPAN_RE.search(conv_value)
            replace_set = [("<s0>", m.group(1)), ("<e0>", m.group(3))]
        else:
            replace_set = []
            for k, v in meta["token"].items():
                if cfg.debug_window != 0:
                    dur = cfg.debug_window * (2 if change_fps else 1)
                    val = (meta_start if k == "<s0>" else meta_end) - start_s \
                        if k in ("<s0>", "<e0>") else v - start_s
                else:
                    dur = meta["duration"]
                    val = v
                replace_set.append((k, timestamp_to_frame_token(dur, val, cfg.num_frames)))
            for turn in source["conversations"]:
                for x1, x2 in replace_set:
                    turn["value"] = turn["value"].replace(x1, x2)

        if neg:
            source["conversations"][1]["value"] = self.neg_value

        processed = preprocess_v1(
            source["conversations"],
            self.tokenizer,
            self.model_max_length,
            ignore_temporal=cfg.ignore_temporal,
        )

        out: Dict[str, Any] = {
            "input_ids": processed["input_ids"],
            "labels": processed["labels"],
            "image": np.asarray(image),
            "hier_neg_start": start,
        }
        if query_feat is not None:
            out["query_feat"] = query_feat
            out["query_cls"] = query_cls
        if replace_set and conv_value is None:
            out["start_end_frame"] = [int(x2) for _, x2 in replace_set]
        if cfg.stream:
            out["neg"] = 0 if neg else 1
        return out
