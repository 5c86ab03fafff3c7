"""Host-side prefetch for the eval CLIs: `prefetch_map` from
revisionllm_tpu/data/prefetcher.py. The JAX module's DevicePrefetcher (a
jax.device_put double buffer) has no user in the port: the engine ships
each movie to the device itself."""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator


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
