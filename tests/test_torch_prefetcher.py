"""data/prefetcher.py: DevicePrefetcher (the port's counterpart of JAX's
double buffer) and prefetch_map, on the CPU. Batches come out in order and
whole, the stream ends where its source ends, an error in the source is
raised on the consumer's side after the batches before it, and on the CPU
the tensors pass as they are (no copy). JAX's DevicePrefetcher is held to
the same order and the same error. The CUDA route (pinned memory, a side
stream, an event) runs in chip_smoke.py."""

import threading

import numpy as np
import pytest
import torch

from revisionllm_tpu.data.prefetcher import DevicePrefetcher as JPrefetcher
from revisionllm_tpu_torch.data.prefetcher import DevicePrefetcher, prefetch_map


def _batches(n):
    return [{"images": torch.full((2, 3), float(i)), "ids": torch.arange(4) + i,
             "nested": {"x": [torch.tensor(i)]}, "step": i} for i in range(n)]


@pytest.mark.parametrize("size", [1, 2, 4])
def test_order_and_end_of_stream(size):
    src = _batches(7)
    got = list(DevicePrefetcher(iter(src), size=size, device="cpu"))
    assert len(got) == 7 and [b["step"] for b in got] == list(range(7))
    for b, want in zip(got, src):
        assert b is want                                   # the CPU takes them as they are
        assert b["images"] is want["images"] and b["nested"]["x"][0] is want["nested"]["x"][0]
    want = [np.asarray(b["images"]) for b in JPrefetcher([{"images": np.full((2, 3), float(i))}
                                                          for i in range(7)], size=size)]
    assert [float(b["images"][0, 0]) for b in got] == [float(w[0, 0]) for w in want]
    assert list(DevicePrefetcher([], device="cpu")) == []


def _failing(n):
    for i in range(n):
        yield {"step": i}
    raise ValueError("corrupt record")


def test_error_is_raised_on_the_consumer_side():
    seen = []
    with pytest.raises(ValueError, match="corrupt record"):
        for b in DevicePrefetcher(_failing(3), device="cpu"):
            seen.append((b["step"], threading.current_thread() is threading.main_thread()))
    assert seen == [(0, True), (1, True), (2, True)]
    jseen = []
    with pytest.raises(ValueError, match="corrupt record"):
        for b in JPrefetcher(_failing(3)):
            jseen.append(b["step"])
    assert [int(s) for s in jseen] == [0, 1, 2]


def test_fills_ahead_in_a_thread():
    """The fill thread stays at most `size` batches ahead of the consumer."""
    produced = []

    def source():
        for i in range(6):
            produced.append(i)
            yield {"step": i}

    it = iter(DevicePrefetcher(source(), size=2, device="cpu"))
    first = next(it)
    for _ in range(200):
        if len(produced) >= 3:
            break
        threading.Event().wait(0.005)
    assert first["step"] == 0 and 3 <= len(produced) <= 4
    assert [b["step"] for b in it] == [1, 2, 3, 4, 5]


def test_prefetch_map_order_and_error():
    assert list(prefetch_map(lambda x: x * x, range(6))) == [0, 1, 4, 9, 16, 25]

    def fn(x):
        if x == 2:
            raise KeyError("missing query")
        return x

    out = []
    with pytest.raises(KeyError, match="missing query"):
        for v in prefetch_map(fn, range(5)):
            out.append(v)
    assert out == [0, 1]
