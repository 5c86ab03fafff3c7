"""The (data, fsdp, tensor) mesh over torch.distributed.

Counterpart of revisionllm_tpu/parallel/mesh.py, with the same axes:

  data   - batch (pure data parallel)
  fsdp   - parameters sharded (ZeRO-3), each layer gathered just before it
           runs; the batch is also split over this axis
  tensor - Megatron tensor parallelism inside attention and the MLP

GSPMD emits JAX's collectives from sharding annotations; here the model code
calls them by hand (parallel/comm.py) on the process groups this mesh names.
The layout of ranks is torch.distributed.device_mesh.init_device_mesh's:
each rank's coordinates and every group, the flattened batch axes' too,
are read from that DeviceMesh.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

AXES = ("data", "fsdp", "tensor")

# Batch axes: data-parallel over both the pure-DP axis and the FSDP axis
# (ZeRO shards params over data-parallel workers, it does not change the
# batch math).
BATCH_AXES = ("data", "fsdp")


class Mesh:
    """A named (dp, fsdp, tp) layout of the world's ranks, with a process
    group for each axis, one for the flattened batch axes ("batch") and the
    world's ("world").
    `shape` maps each axis to its size, as jax.sharding.Mesh.shape does. A
    one-rank mesh holds no groups: code given it runs as with no mesh."""

    axis_names = AXES

    def __init__(self, dp: int, fsdp: int, tp: int, device_mesh=None,
                 groups: Optional[Dict[str, object]] = None):
        self.shape = {"data": dp, "fsdp": fsdp, "tensor": tp}
        self.device_mesh = device_mesh
        self._groups = groups or {}
        coord = (0, 0, 0) if device_mesh is None else device_mesh.get_coordinate()
        self._coord = dict(zip(AXES, coord))

    @property
    def devices_shape(self):
        return tuple(self.shape[a] for a in AXES)

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["fsdp"] * self.shape["tensor"]

    def coord(self, axis: str) -> int:
        """This rank's index along `axis` ("batch": along the flattened
        (data, fsdp) axes; "world": all three)."""
        if axis == "batch":
            return self._coord["data"] * self.shape["fsdp"] + self._coord["fsdp"]
        if axis == "world":
            return self.coord("batch") * self.shape["tensor"] + self._coord["tensor"]
        return self._coord[axis]

    def axis_size(self, axis: str) -> int:
        if axis == "batch":
            return self.shape["data"] * self.shape["fsdp"]
        if axis == "world":
            return self.size
        return self.shape[axis]

    def group(self, axis: str):
        return self._groups[axis]

    def __repr__(self) -> str:
        return "Mesh(" + ", ".join(f"{a}={self.shape[a]}" for a in AXES) + ")"


def create_mesh(dp: int = 1, fsdp: int = 1, tp: int = 1) -> Mesh:
    """The (dp, fsdp, tp) mesh over the world's ranks. Raises ValueError,
    as JAX's does, when it needs more ranks than the world has; it also
    raises when it would leave ranks out (each rank runs the same program,
    so a rank outside the mesh would have nothing to do). A one-rank mesh in
    a single process needs no process group."""
    n = dp * fsdp * tp
    if min(dp, fsdp, tp) < 1:
        raise ValueError(f"mesh {dp}x{fsdp}x{tp}: every axis needs at least one rank")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n > world:
        raise ValueError(f"mesh {dp}x{fsdp}x{tp} needs {n} ranks, have {world}")
    if n < world:
        raise ValueError(f"mesh {dp}x{fsdp}x{tp} uses {n} of the world's {world} ranks; "
                         f"start {n} processes")
    if world == 1:
        return Mesh(dp, fsdp, tp)
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cpu" if dist.get_backend() == "gloo" else "cuda"
    device_mesh = init_device_mesh(device_type, (dp, fsdp, tp), mesh_dim_names=AXES)
    groups = {axis: device_mesh.get_group(axis) for axis in AXES}
    groups["world"] = dist.group.WORLD
    rank = dist.get_rank()
    for t in range(tp):  # every rank creates every group, in the same order
        ranks = device_mesh.mesh[:, :, t].flatten().tolist()
        g = dist.new_group(ranks)
        if rank in ranks:
            groups["batch"] = g
    return Mesh(dp, fsdp, tp, device_mesh, groups)


def single_device_mesh() -> Mesh:
    return create_mesh(1, 1, 1)


class BatchShard:
    """This rank's rows of a batch split over the (data, fsdp) axes, and the
    gather that puts the whole batch back together on every rank. A batch
    whose size the axes do not divide stays whole (replicated), as JAX's
    engine leaves it (revisionllm_tpu/eval/engine.py:207-219)."""

    def __init__(self, mesh: Optional[Mesh]):
        self.mesh = mesh
        self.n = 1 if mesh is None else mesh.axis_size("batch")
        self.index = 0 if mesh is None else mesh.coord("batch")

    def splits(self, batch: int) -> bool:
        return self.n > 1 and batch % self.n == 0

    def local(self, t, batch: int, dim: int = 0):
        """Rows [index * batch / n, (index + 1) * batch / n) along `dim` of a
        tensor or array whose `dim` is the batch of size `batch`; the whole
        when the batch is not split."""
        if not self.splits(batch):
            return t
        b = batch // self.n
        sl = [slice(None)] * (dim + 1)
        sl[dim] = slice(self.index * b, (self.index + 1) * b)
        return t[tuple(sl)]

    def gather(self, t: torch.Tensor, batch: int, dim: int = 0) -> torch.Tensor:
        """The whole batch from each rank's rows (`t` as is when the batch
        was not split)."""
        if not self.splits(batch):
            return t
        from revisionllm_tpu_torch.parallel import comm

        return comm.all_gather(t, self.mesh, "batch", dim)


def batch_sharding(mesh: Optional[Mesh]) -> BatchShard:
    return BatchShard(mesh)
