"""Feature stores: host-DRAM-backed key -> array blobs feeding the input
pipeline. A host copy of revisionllm_tpu/data/feature_store.py.

The reference keeps pre-extracted CLIP features in LMDB environments holding
npz records (reference revisionllm/train/dataset.py:508-528,
eval_nlq_negative.py:150-155) or bare .npy files per video. Replacements here:

- `NpyFeatureStore` — directory of `<key>.npy` (drop-in for the reference's
  vis_feat_storage='npy' path).
- `RvfsStore` — our own single-file memory-mapped store ("RVFS"): a JSON
  index + raw little-endian blobs. Zero-copy reads via np.memmap; the whole
  file stays in page cache, which is what LMDB provided. A native C++ reader
  with background prefetch threads lives in native/ (see fstore.cc) and is
  used automatically when built.
- `QueryFeatureStore` — wraps either store; returns (token_features,
  l2-normalized cls_features) per query id (parity: dataset.py:530-558
  including the eot_features fallback and cls[0] squeeze).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Tuple

import numpy as np

MAGIC = b"RVFS0001"


class NpyFeatureStore:
    def __init__(self, root: str):
        self.root = root

    def get(self, key: str) -> np.ndarray:
        return np.load(os.path.join(self.root, key + ".npy"))

    def __contains__(self, key: str) -> bool:
        return os.path.isfile(os.path.join(self.root, key + ".npy"))


class RvfsWriter:
    """Single-file store writer. Layout:
    [MAGIC][u64 index_len][index JSON][aligned blobs...]
    Index: {key: {"offset": int, "shape": [...], "dtype": str}} (or a dict of
    named arrays per key for npz-style records)."""

    def __init__(self, path: str):
        self.path = path
        self._entries: Dict[str, dict] = {}
        self._blobs = []
        self._cursor = 0

    def _align(self, n: int, a: int = 64) -> int:
        return (n + a - 1) // a * a

    def add(self, key: str, arrays: Dict[str, np.ndarray]) -> None:
        rec = {}
        for name, arr in arrays.items():
            arr = np.ascontiguousarray(arr)
            off = self._align(self._cursor)
            pad = off - self._cursor
            if pad:
                self._blobs.append(b"\x00" * pad)
            self._blobs.append(arr.tobytes())
            rec[name] = {
                "offset": off,
                "shape": list(arr.shape),
                "dtype": arr.dtype.str,
            }
            self._cursor = off + arr.nbytes
        self._entries[key] = rec

    def close(self) -> None:
        index = json.dumps(self._entries).encode()
        with open(self.path, "wb") as f:
            f.write(MAGIC)
            f.write(struct.pack("<Q", len(index)))
            f.write(index)
            for blob in self._blobs:
                f.write(blob)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class RvfsStore:
    """Memory-mapped reader. `get(key)` returns the record's single array (or
    the 'features' array); `get_record(key)` returns all named arrays."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            magic = f.read(8)
            if magic != MAGIC:
                raise ValueError(f"{path}: not an RVFS file")
            (index_len,) = struct.unpack("<Q", f.read(8))
            self.index = json.loads(f.read(index_len))
            self._data_start = 16 + index_len
        self._mmap = np.memmap(path, dtype=np.uint8, mode="r", offset=self._data_start)

    def keys(self):
        return self.index.keys()

    def __contains__(self, key: str) -> bool:
        return key in self.index

    def _read(self, meta: dict) -> np.ndarray:
        dtype = np.dtype(meta["dtype"])
        count = int(np.prod(meta["shape"])) if meta["shape"] else 1
        start = meta["offset"]
        raw = self._mmap[start : start + count * dtype.itemsize]
        return np.frombuffer(raw, dtype=dtype).reshape(meta["shape"])

    def get_record(self, key: str) -> Dict[str, np.ndarray]:
        return {name: self._read(meta) for name, meta in self.index[key].items()}

    def get(self, key: str) -> np.ndarray:
        rec = self.index[key]
        if "features" in rec:
            return self._read(rec["features"])
        if "memory_global" in rec:  # reference fallback (dataset.py:521)
            return self._read(rec["memory_global"])
        return self._read(next(iter(rec.values())))


def open_feature_store(path: str):
    """Auto-detect store type: .rvfs file or npy directory."""
    if os.path.isfile(path):
        return RvfsStore(path)
    if os.path.isdir(path):
        return NpyFeatureStore(path)
    raise FileNotFoundError(path)


def l2_normalize_np(x: np.ndarray, eps: float = 1e-5) -> np.ndarray:
    """(parity: dataset.py:556-558 — eps added to the norm)."""
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + eps)


class QueryFeatureStore:
    def __init__(self, path: str):
        self.store = open_feature_store(path)

    def get(self, qid: str) -> Tuple[np.ndarray, np.ndarray]:
        if isinstance(self.store, RvfsStore):
            rec = self.store.get_record(qid)
        else:
            with np.load(os.path.join(self.store.root, qid + ".npz")) as z:
                rec = {k: z[k] for k in z.files}
        q_feat = rec["token_features"]
        cls = rec.get("cls_features", rec.get("eot_features"))
        if cls.ndim == 2:
            cls = cls[0]
        return q_feat, l2_normalize_np(cls)
