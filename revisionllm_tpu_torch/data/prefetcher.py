"""Host -> device prefetch: revisionllm_tpu/data/prefetcher.py in PyTorch.

`DevicePrefetcher` is the double buffer that feeds the device (JAX's
prefetcher.py:19-62): a fill thread stages batch N+1 on the device while the
step consumes batch N. `prefetch_map` runs host-side work (per-query feature
loads, collation) in a background thread ahead of its consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

import torch

from revisionllm_tpu_torch.utils.device import resolve_device

def _map_tensors(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


class DevicePrefetcher:
    """Wraps an iterator of host batches (trees of CPU tensors); yields them
    on `device` (default CUDA), in order, `size` batches ahead (2: double buffering).

    On a CUDA device the fill thread copies each tensor into pinned host
    memory and from there with a non_blocking copy on a side stream, then
    records an event; the consumer's stream waits on that event before the
    batch is handed over (and the tensors are marked as used on it). On the
    CPU the batches pass as they are. An error in the source iterator or a
    copy is raised on the consumer's side."""

    def __init__(self, batches: Iterable[Any], size: int = 2, device=None):
        self._it = iter(batches)
        self._device = resolve_device(device)
        self._cuda = self._device.type == "cuda"
        self._stream = torch.cuda.Stream(device=self._device) if self._cuda else None
        self._q: "queue.Queue" = queue.Queue(maxsize=size)
        self._done = object()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _put_device(self, batch):
        if not self._cuda:
            return batch, None
        with torch.cuda.stream(self._stream):
            out = _map_tensors(
                lambda t: t.pin_memory().to(self._device, non_blocking=True), batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _fill(self):
        try:
            for batch in self._it:
                self._q.put(self._put_device(batch))
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._q.put(self._done)

    def __iter__(self) -> Iterator[Any]:
        while True:
            item = self._q.get()
            if item is self._done:
                if self._err is not None:
                    raise self._err
                return
            batch, event = item
            if event is not None:
                current = torch.cuda.current_stream(self._device)
                current.wait_event(event)
                _map_tensors(lambda t: t.record_stream(current), batch)
            yield batch


def prefetch_map(
    fn: Callable[[Any], Any], items: Iterable[Any], size: int = 2
) -> Iterator[Any]:
    """Yield fn(item) for each item, computed in a background thread up to
    `size` items ahead (the per-query feature loads overlap the device work
    of the query before). An exception in fn is raised to the consumer."""

    q: "queue.Queue" = queue.Queue(maxsize=size)
    done = object()
    err: list = []

    def fill():
        try:
            for item in items:
                q.put(fn(item))
        except BaseException as e:
            err.append(e)
        finally:
            q.put(done)

    threading.Thread(target=fill, daemon=True).start()
    while True:
        item = q.get()
        if item is done:
            if err:
                raise err[0]
            return
        yield item
