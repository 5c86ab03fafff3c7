"""ctypes binding for the native RVFS reader (native/fstore.cc), the port's
copy of revisionllm_tpu/data/native_store.py.

The library is built with the host's C++ compiler from native/fstore.cc at
first use, into build/native/libfstore-<hash of source and flags>.so (the
native/ directory is never written). Without a compiler or a library,
`open_store_native` falls back to the NumPy reader (data/feature_store.py),
as JAX's does; `NativeRvfsStore` itself raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from revisionllm_tpu_torch.data.feature_store import RvfsStore

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "fstore.cc"
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")  # native/Makefile's

_lib = None
_lib_error: Optional[str] = None


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler found (g++, c++ or $CXX)")
    return cxx


def library_path() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libfstore-{tag}.so"


def build_library() -> Path:
    """The library for this source, compiled unless it is there already
    (written under a temporary name, then renamed: concurrent builds do not
    see a partial file)."""
    out = library_path()
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, out)
    return out


def _load_lib():
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(build_library()))
        lib.fstore_open.restype = ctypes.c_void_p
        lib.fstore_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.fstore_close.argtypes = [ctypes.c_void_p]
        lib.fstore_read.restype = ctypes.c_uint64
        lib.fstore_read.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p,
        ]
        lib.fstore_view.restype = ctypes.c_void_p
        lib.fstore_view.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.fstore_prefetch.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64]
        lib.fstore_pending.restype = ctypes.c_int
        lib.fstore_pending.argtypes = [ctypes.c_void_p]
        lib.fstore_size.restype = ctypes.c_uint64
        lib.fstore_size.argtypes = [ctypes.c_void_p]
        _lib = lib
    except Exception as e:  # no compiler, a failed build, an unloadable library
        _lib_error = str(e)
        _lib = None
    return _lib


def native_available() -> bool:
    return _load_lib() is not None


def _nbytes(meta: dict) -> int:
    dtype = np.dtype(meta["dtype"])
    return (int(np.prod(meta["shape"])) if meta["shape"] else 1) * dtype.itemsize


class NativeRvfsStore:
    """RVFS reader backed by the C++ mmap/prefetch library.

    Same `get`/`get_record` interface as RvfsStore plus `prefetch(keys)`,
    which warms upcoming records in worker threads while the device
    computes, and `pending()`, the prefetch tasks not yet done."""

    def __init__(self, path: str, num_threads: int = 2):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(f"native fstore unavailable: {_lib_error}")
        self._lib = lib
        self._py = RvfsStore(path)  # the index, parsed in Python
        self.index = self._py.index
        self._data_start = self._py._data_start
        self._handle = lib.fstore_open(path.encode(), num_threads)
        if not self._handle:
            raise RuntimeError(f"fstore_open failed for {path}")

    def close(self):
        if self._handle:
            self._lib.fstore_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __contains__(self, key: str) -> bool:
        return key in self.index

    def keys(self):
        return self.index.keys()

    def _read_meta(self, meta: dict) -> np.ndarray:
        nbytes = _nbytes(meta)
        out = np.empty(nbytes // np.dtype(meta["dtype"]).itemsize, dtype=np.dtype(meta["dtype"]))
        got = self._lib.fstore_read(
            self._handle, self._data_start + meta["offset"], nbytes,
            out.ctypes.data_as(ctypes.c_void_p),
        )
        if got != nbytes:
            raise IOError(f"short read: {got} != {nbytes}")
        return out.reshape(meta["shape"])

    def get_record(self, key: str) -> Dict[str, np.ndarray]:
        return {name: self._read_meta(m) for name, m in self.index[key].items()}

    def get(self, key: str) -> np.ndarray:
        rec = self.index[key]
        if "features" in rec:
            return self._read_meta(rec["features"])
        if "memory_global" in rec:
            return self._read_meta(rec["memory_global"])
        return self._read_meta(next(iter(rec.values())))

    def prefetch(self, keys) -> None:
        for key in keys:
            for meta in self.index.get(key, {}).values():
                self._lib.fstore_prefetch(self._handle, self._data_start + meta["offset"],
                                          _nbytes(meta))

    def pending(self) -> int:
        return self._lib.fstore_pending(self._handle)


def open_store_native(path: str, num_threads: int = 2):
    """The best store available: the native reader if the library builds,
    else the NumPy reader."""
    if os.path.isfile(path) and native_available():
        try:
            return NativeRvfsStore(path, num_threads)
        except Exception:
            pass
    from revisionllm_tpu_torch.data.feature_store import open_feature_store

    return open_feature_store(path)
