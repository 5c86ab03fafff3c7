"""Port parity: data/native_store.py, the ctypes binding of native/fstore.cc.
The port builds the library with the host's C++ compiler into
build/native/ (keyed by the source's hash) and never writes into native/;
its reader returns what the Python RVFS reader returns, record for record,
and its prefetch queue drains. Skips only where no C++ compiler is found."""

import hashlib
import shutil
import time

import numpy as np
import pytest

from revisionllm_tpu.data import native_store as jnative
from revisionllm_tpu_torch.data import native_store as tnative
from revisionllm_tpu_torch.data.feature_store import RvfsStore, RvfsWriter

pytestmark = pytest.mark.skipif(
    not (shutil.which("g++") or shutil.which("c++")), reason="no C++ compiler found")


@pytest.fixture(scope="module")
def store_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("native") / "feat.rvfs")
    rng = np.random.default_rng(0)
    with RvfsWriter(path) as w:
        for i in range(5):
            w.add(f"movie{i}", {"features": rng.normal(size=(100, 16)).astype(np.float32)})
        w.add("rec", {"token_features": rng.normal(size=(7, 16)).astype(np.float32),
                      "cls_features": rng.normal(size=(16,)).astype(np.float32),
                      "ids": np.arange(5, dtype=np.int64), "flag": np.ones((), np.int32)})
        w.add("mem", {"memory_global": rng.normal(size=(3, 16)).astype(np.float16)})
    return path


def _digest(paths):
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest() for p in paths}


def test_builds_under_build_native_not_native(tmp_path, monkeypatch):
    """A fresh build (into a temporary BUILD_DIR) writes only there, under
    the hashed name; the sources in native/ keep their bytes, and the
    default location is the checkout's build/native/."""
    tracked = [tnative.SOURCE, tnative.SOURCE.parent / "Makefile"]
    before = _digest(tracked)
    assert tnative.library_path().parent == tnative.ROOT / "build" / "native"
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build" / "native")
    lib = tnative.build_library()
    assert lib.parent == tmp_path / "build" / "native" and lib.name.startswith("libfstore-")
    assert [p.name for p in lib.parent.iterdir()] == [lib.name]
    assert tnative.build_library() == lib                  # built once
    assert _digest(tracked) == before
    assert not list(tnative.SOURCE.parent.glob("libfstore-*"))


def test_native_reader_matches_python_reader(store_path):
    assert tnative.native_available()
    py, nat = RvfsStore(store_path), tnative.NativeRvfsStore(store_path)
    want = jnative.RvfsStore(store_path)   # the JAX package's reader of the same file
    assert sorted(nat.keys()) == sorted(py.keys()) == sorted(want.keys())
    for key in py.keys():
        got = nat.get_record(key)
        assert set(got) == set(py.get_record(key))
        for name, arr in py.get_record(key).items():
            assert got[name].dtype == arr.dtype and np.array_equal(got[name], arr)
            assert np.array_equal(got[name], want.get_record(key)[name])
        assert np.array_equal(nat.get(key), py.get(key))
    assert "movie3" in nat and "nope" not in nat
    nat.close()
    nat.close()   # a second close is a no-op


def test_prefetch_and_pending(store_path):
    nat = tnative.NativeRvfsStore(store_path, num_threads=3)
    nat.prefetch([f"movie{i}" for i in range(5)] + ["rec", "missing"])
    for _ in range(500):
        if nat.pending() == 0:
            break
        time.sleep(0.01)
    assert nat.pending() == 0
    assert np.array_equal(nat.get("movie0"), RvfsStore(store_path).get("movie0"))
    nat.close()


def test_open_store_native_routes(store_path, tmp_path, monkeypatch):
    """A file opens natively; a directory falls back to the npy reader; a
    library that cannot be built falls back to the Python reader, and
    NativeRvfsStore then raises."""
    assert isinstance(tnative.open_store_native(store_path), tnative.NativeRvfsStore)
    assert type(tnative.open_store_native(str(tmp_path))).__name__ == "NpyFeatureStore"
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_lib_error", "no compiler")
    assert isinstance(tnative.open_store_native(store_path), RvfsStore)
    with pytest.raises(RuntimeError, match="native fstore unavailable"):
        tnative.NativeRvfsStore(store_path)
