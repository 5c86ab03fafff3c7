"""Spans at the port's layer boundaries: the one record of where a
request's time goes, on the host's clock and, where asked, the device's.

    from revisionllm_tpu_torch.utils import spans

    with spans.enabled():
        engine.ground_windows(...)
    spans.summary()   # {name: {count, host_ms, self_host_ms, device_ms}}

`span(name, device=False, **attrs)` is a context manager. Off (the
default), with no profiler running, it returns one shared null context:
no allocation, no clock read, no record. On (`enable(True)` or
`enabled()`), it records the span's name, its id, its parent's id, the
request id and its host interval (`time.perf_counter_ns`), with `attrs`,
the counts taken at the same boundary (`note` adds to them from inside;
a count may be a device scalar, read when the records are).
With `device` a CUDA `torch.device`, the span also records a timing event
on the device's current stream at entry and at exit: its device interval
is when the stream reached those points. A span opened with no span open
(on this thread) is a request's root and takes a new request id; the
spans beneath it carry that id.

Whenever `torch.profiler` runs, on or off, each span is also a
`record_function` range of the same name, so the spans sit on the
profiler's timeline beside the device's operations.

Spans are kept in memory until `reset()`. `records()` returns the finished
ones as dicts (the benchmark's readers, `benchmark/benchlib/spans.py`,
read these keys): name, id, parent (None for a root), request, start_ns,
end_ns, host_ms, attrs, and device_start_ms, device_end_ms, device_ms
(milliseconds from the first device event since the last reset; None
without a device interval). Device intervals are resolved there, after a
synchronise. Nothing runs at import, and no environment variable switches
it.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import torch

_clock = time.perf_counter_ns
_NULL = contextlib.nullcontext()


class _State:
    def __init__(self):
        self.on = False
        self.done: List["_Span"] = []
        self.local = threading.local()  # .stack: this thread's open spans
        self.span_ids = itertools.count(1)
        self.request_ids = itertools.count(1)
        self.origin = None  # the first device event since the last reset


_S = _State()


def _profiling() -> bool:
    return torch.autograd._profiler_enabled()


class _Span:
    __slots__ = ("name", "id", "parent", "request", "attrs", "start_ns", "end_ns", "events",
                 "interval", "_range", "_stream")

    def __init__(self, name: str, device, attrs: Dict[str, Any], record: bool):
        self.name, self.attrs = name, attrs
        self._range = None
        self.events = None
        self.interval = None
        self._stream = None
        self.id = next(_S.span_ids) if record else None
        if record and isinstance(device, torch.device) and device.type == "cuda":
            self._stream = torch.cuda.current_stream(device)

    def __enter__(self):
        if _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self.id is None:
            return self
        stack = _stack()
        if stack:
            self.parent, self.request = stack[-1].id, stack[-1].request
        else:
            self.parent, self.request = None, next(_S.request_ids)
        stack.append(self)
        if self._stream is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(self._stream)
            self.events = (start, None)
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc):
        if self.id is not None:
            self.end_ns = _clock()
            if self.events is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record(self._stream)
                self.events = (self.events[0], end)
            stack = _stack()
            if stack and stack[-1] is self:
                stack.pop()
            _S.done.append(self)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def _stack() -> list:
    st = getattr(_S.local, "stack", None)
    if st is None:
        st = _S.local.stack = []
    return st


def span(name: str, device=False, **attrs):
    """A span named `name` around a `with` block (module docstring).
    `device`: the `torch.device` the block's work runs on; a CUDA device
    gives the span a device interval."""
    if _S.on:
        return _Span(name, device, attrs, True)
    if _profiling():
        return _Span(name, device, attrs, False)
    return _NULL


def note(**attrs) -> None:
    """Add counts to the innermost open span of this thread (nothing when
    spans are off)."""
    if _S.on:
        stack = _stack()
        if stack:
            stack[-1].attrs.update(attrs)


def recording() -> bool:
    """Whether spans are being recorded (counts that cost device work are
    taken only then)."""
    return _S.on


def enable(on: bool = True) -> None:
    """Switch recording on or off (off by default)."""
    _S.on = bool(on)


@contextlib.contextmanager
def enabled(on: bool = True):
    """Record spans inside the block; the former state after it."""
    was = _S.on
    enable(on)
    try:
        yield
    finally:
        enable(was)


def reset() -> None:
    """Forget every finished span and the device origin."""
    _S.done = []
    _S.origin = None


def _resolve(done: List[_Span]) -> None:
    """Device intervals of the spans whose events are not read yet, in ms
    from the first device event since the last reset (synchronises)."""
    todo = [s for s in done if s.events is not None and s.interval is None]
    if not todo:
        return
    torch.cuda.synchronize()
    if _S.origin is None:
        _S.origin = todo[0].events[0]
    for s in todo:
        a, b = s.events
        s.interval = (_S.origin.elapsed_time(a), _S.origin.elapsed_time(b))


def records() -> List[Dict[str, Any]]:
    """The finished spans, in the order they ended (module docstring)."""
    done = list(_S.done)
    _resolve(done)
    out = []
    for s in done:
        dev = s.interval
        out.append({
            "name": s.name, "id": s.id, "parent": s.parent, "request": s.request,
            "start_ns": s.start_ns, "end_ns": s.end_ns,
            "host_ms": (s.end_ns - s.start_ns) / 1e6, "attrs": _host_attrs(s.attrs),
            "device_start_ms": None if dev is None else dev[0],
            "device_end_ms": None if dev is None else dev[1],
            "device_ms": None if dev is None else dev[1] - dev[0],
        })
    return out


def _host_attrs(attrs: Dict[str, Any]) -> Dict[str, Any]:
    """A span's counts, those noted as device scalars read as numbers
    (`records` has synchronised)."""
    return {k: v.item() if isinstance(v, torch.Tensor) else v for k, v in attrs.items()}


def self_host_ms(recs: List[Dict[str, Any]]) -> Dict[int, float]:
    """Each span's host duration less the part of it its children cover
    (the union of their intervals, clipped to it), by span id."""
    children: Dict[Optional[int], list] = {}
    for r in recs:
        children.setdefault(r["parent"], []).append((r["start_ns"], r["end_ns"]))
    out = {}
    for r in recs:
        lo, hi = r["start_ns"], r["end_ns"]
        covered, t = 0, lo
        for s, e in sorted(children.get(r["id"], ())):
            s, e = max(s, t), min(e, hi)
            if e > s:
                covered += e - s
                t = e
        out[r["id"]] = (hi - lo - covered) / 1e6
    return out


def summary() -> Dict[str, Dict[str, Any]]:
    """By name: count, host_ms, self_host_ms and device_ms (None when no
    span of the name had a device interval), summed over the finished
    spans."""
    recs = records()
    own = self_host_ms(recs)
    out: Dict[str, Dict[str, Any]] = {}
    for r in recs:
        row = out.setdefault(r["name"], {"count": 0, "host_ms": 0.0, "self_host_ms": 0.0,
                                         "device_ms": None})
        row["count"] += 1
        row["host_ms"] += r["host_ms"]
        row["self_host_ms"] += own[r["id"]]
        if r["device_ms"] is not None:
            row["device_ms"] = (row["device_ms"] or 0.0) + r["device_ms"]
    return out
