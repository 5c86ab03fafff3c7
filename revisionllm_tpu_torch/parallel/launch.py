"""Process-group start-up, the static work split, and a rank spawner.

Counterpart of revisionllm_tpu/parallel/launch.py. JAX starts one process a
host with `jax.distributed.initialize`; here every rank is a process of its
own, started by torchrun (which sets MASTER_ADDR, MASTER_PORT, RANK,
WORLD_SIZE and LOCAL_RANK) or by `spawn`, and joins one process group:

    torchrun --nproc_per_node 4 -m revisionllm_tpu_torch.eval.stage1 --mesh 1,1,4 ...

The backend is always named: NCCL for CUDA, gloo for the CPU, unless the
caller passes another (gloo over CUDA tensors stages them through the host;
it is how several ranks share one card, which NCCL refuses). Collectives
time out after `timeout_s`, so a rank that never arrives fails the others
instead of hanging them.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


def default_backend(device: Optional[Any] = None) -> str:
    """NCCL for a CUDA device, gloo for the CPU. device None means CUDA
    when the machine has it (the entry points' default device)."""
    if device is None:
        return "nccl" if torch.cuda.is_available() else "gloo"
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    device: Optional[Any] = None,
) -> bool:
    """Join the process group; returns whether this process is part of a
    group (False: a single process that no launcher started, a no-op).

    With no arguments it reads torchrun's MASTER_ADDR / MASTER_PORT / RANK /
    WORLD_SIZE; `coordinator_address` ("host:port" or a "tcp://" URL),
    `num_processes` and `process_id` override them. The backend is
    `backend`, else default_backend(device). When CUDA is present (and
    `device` is not the CPU), the current device becomes LOCAL_RANK (0
    without it): ranks that share a card are given the same LOCAL_RANK. A
    second call is a no-op."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize_distributed needs a coordinator address, the number of "
                         "processes and this process's rank (or torchrun's environment)")
    if not timeout_s or timeout_s <= 0 or timeout_s == float("inf"):
        raise ValueError(f"the collective timeout must be finite and positive, got {timeout_s}")
    backend = backend or default_backend(device)
    if torch.cuda.is_available() and (device is None or torch.device(device).type == "cuda"):
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0, or a single process: the one that writes files."""
    return process_index() == 0


def barrier() -> None:
    """Wait for every rank (a no-op in a single process)."""
    if dist.is_initialized():
        dist.barrier()


def host_shard_indices(n_items: int) -> range:
    """This rank's share of a work list: world-size bins of n // world items,
    the last rank taking the remainder (JAX's launch.py:40-48)."""
    p, n = process_index(), process_count()
    binsize = n_items // n
    start = p * binsize
    end = n_items if p == n - 1 else start + binsize
    return range(start, end)


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, nprocs, port, backend, timeout_s, cards, fn, args, queue):
    try:
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                          WORLD_SIZE=str(nprocs), LOCAL_RANK=str(rank % cards if cards else 0))
        initialize_distributed(backend=backend, timeout_s=timeout_s,
                               device=None if cards else "cpu")
        # plain pickle bytes: torch's queue reducer would pass tensors as
        # shared-memory handles that die with this process
        result = pickle.dumps(fn(*args))
        queue.put((rank, True, result))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))  # the parent raises it
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: Sequence = (), backend: str = "gloo",
          timeout_s: float = 300.0, cards: Optional[int] = None) -> List[Any]:
    """Run fn(*args) in `nprocs` new processes that form one process group
    over `backend`, and return their results in rank order.

    `fn` must be importable (a module-level function) and its results
    picklable. cards: the CUDA devices the ranks map onto (rank % cards;
    default every visible card, 0 for CPU-only ranks). Raises RuntimeError
    with the rank's traceback when a rank fails, TimeoutError when the ranks
    have not all finished within `timeout_s` seconds; either way every
    process it started is stopped before it returns."""
    import queue as queue_mod
    import time

    import torch.multiprocessing as mp

    if cards is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, nprocs, port, backend, timeout_s, cards, fn, tuple(args),
                               results), daemon=True)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"spawn: {nprocs - len(out)} of {nprocs} ranks did not "
                                   f"finish within {timeout_s:.0f} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    # a rank that died without reporting (killed, or lost in C++)
                    time.sleep(1.0)
                    if results.empty():
                        raise RuntimeError(f"spawn: rank(s) {dead} exited with codes "
                                           f"{[procs[r].exitcode for r in dead]} and no result")
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{value}")
            out[rank] = pickle.loads(value)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return [out[r] for r in range(nprocs)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
