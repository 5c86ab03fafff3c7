"""Collectives over a mesh axis, and Megatron's tensor-parallel regions.

Every collective the sharded model runs goes through `all_reduce` or
`all_gather` here, which count it in STATS (calls and the bytes each rank
sends in: the tensor for an all-reduce, the gathered output for an
all-gather), so a caller can read what a chunk or a step exchanged. Each
is also a span, `comm.all_reduce` or `comm.all_gather` with its bytes
(utils/spans.py): with spans on, how long it took on both clocks.

Training needs three autograd functions on the `tensor` axis, with the
backward Megatron gives them:

- `copy_to_tensor`: identity forward; the backward sums the gradient over
  the axis (the input of a column-parallel matmul feeds every rank's slice);
- `reduce_from_tensor`: sums a row-parallel matmul's partial outputs (in
  f32); the backward passes the gradient through as is;
- `gather_from_tensor`: concatenates the ranks' slices of the last dim; the
  backward keeps this rank's slice of the gradient.

torch.distributed.nn.functional.all_reduce would also sum the gradient in
its backward, which multiplies every replicated gradient by the axis size.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from revisionllm_tpu_torch.utils import spans

STATS: collections.Counter = collections.Counter()


def reset_stats() -> None:
    """Zero STATS."""
    STATS.clear()


def all_reduce(t: torch.Tensor, mesh, axis: str, op: str = "sum") -> torch.Tensor:
    """Sum (or max) `t` over the axis in place; returns it."""
    nbytes = t.numel() * t.element_size()
    STATS["all_reduce"] += 1
    STATS["all_reduce_bytes"] += nbytes
    with spans.span("comm.all_reduce", device=t.device, bytes=nbytes):
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                        group=mesh.group(axis))
    return t


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The axis's ranks' `t` concatenated along `dim`, in rank order."""
    n = mesh.axis_size(axis)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    nbytes = n * t.numel() * t.element_size()
    STATS["all_gather"] += 1
    STATS["all_gather_bytes"] += nbytes
    with spans.span("comm.all_gather", device=t.device, bytes=nbytes):
        dist.all_gather(parts, t, group=mesh.group(axis))
    return torch.cat(parts, dim=dim)


def local_slice(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's equal slice of `t` along `dim` (a view)."""
    n = mesh.axis_size(axis)
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"dimension {dim} of size {size} does not split over {axis} {n}")
    return t.narrow(dim, mesh.coord(axis) * (size // n), size // n)


class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh, "tensor"), None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.float(), mesh, "tensor").to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_gather(x, mesh, "tensor", dim=x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.mesh, "tensor", g.dim() - 1).contiguous(), None


def _tensor_split(mesh) -> bool:
    return mesh is not None and mesh.shape["tensor"] > 1


def copy_to_tensor(x: torch.Tensor, mesh) -> torch.Tensor:
    """Enter a column-parallel region (a no-op without tensor parallelism
    or without a gradient to sum)."""
    if not _tensor_split(mesh) or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToTensor.apply(x, mesh)


def reduce_from_tensor(x: torch.Tensor, mesh) -> torch.Tensor:
    """Leave a row-parallel region: the partial outputs summed in f32 and
    rounded once to x's type (a bf16 sum would round every partial sum)."""
    if not _tensor_split(mesh):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromTensor.apply(x, mesh)
    return all_reduce(x.float() if x.dtype != torch.float32 else x.contiguous(), mesh,
                      "tensor").to(x.dtype)


def gather_from_tensor(x: torch.Tensor, mesh) -> torch.Tensor:
    """The ranks' slices of the last dim put together (the lm_head's
    vocabulary columns)."""
    if not _tensor_split(mesh):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherFromTensor.apply(x, mesh)
    return all_gather(x, mesh, "tensor", dim=x.dim() - 1)
