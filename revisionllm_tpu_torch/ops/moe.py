"""DeepSeekMoE on the serving path: the router, the dispatch sorted by
expert, the grouped int8 expert products, the combine, and the shared
experts (DeepseekV2MoE in modeling_deepseek.py).

No TPU kernel stands behind this: the JAX package has no mixture of
experts. A layer's work:

- the router in f32 (HF's MoEGate: F.linear in float32, softmax, greedy
  top-k; V2-Lite's `norm_topk_prob` false and `routed_scaling_factor` 1,
  which the loader requires);
- `dispatch`: the T x k routed rows sorted by expert (stable), each
  expert's rows starting at a multiple of `pad` in a buffer of
  `capacity` rows, with the starts and, for the grouped GEMM, each 128-row
  tile's expert and the tile count, all on the device (no host sync);
- the grouped products, one launch per matrix per layer: gate and up as one
  [K, 2F] matrix, then SiLU(gate) x up, then down. Above KERNEL_MAX_M
  rows an expert on average with W8A8 on (the prefill) the rows are
  quantized once and take `grouped_w8a8` (the moe_w8a8 GEMM in
  csrc/w8a8_gemm.cu, K-major weights held at load); otherwise (decode)
  `grouped_w8a16` (the moe_w8a16 kernel in csrc/int8_matmul.cu, K1's
  frame, [K, N] weights). A CPU tensor takes each one's plain version, an
  expert at a time;
- the combine: each token's k outputs weighted by its router weights in
  f32 and summed, rounded once to the activations' type (HF's moe_infer);
- the shared experts, one SwiGLU of width n_shared x F, through
  ops.quant's dense dispatch (the W8A8 prefill kernels and K1).

The expert weights of one layer: {"gu": {"q8" [E, D, 2F], "scale" [E,
2F]}, "gu_t": [E, 2F, D] int8, "down": {"q8" [E, F, D], "scale" [E, D]},
"down_t": [E, D, F] int8}, the *_t copies K-major for the int8 wgmma.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from revisionllm_tpu_torch.ops.quant import (
    KERNEL_MAX_M,
    _int8_dot,
    _sm_count,
    _w8a8_enabled,
    int8_matmul_plain,
    q8_apply,
    q8_apply_multi,
    q8_plan,
    q8_resident,
    quantize_rows,
    w8a8_tile_columns,
)
from revisionllm_tpu_torch.utils import kernels

W8A8_PAD = 128   # the grouped GEMM's rows a tile: each expert's rows start at a multiple
W8A16_MP = 64    # the grouped K1's rows a block


class Dispatch(NamedTuple):
    dest: torch.Tensor          # [T * k] int64: the buffer row of routed row j (token j // k)
    starts: torch.Tensor        # [E + 1] int32: expert e's rows start at starts[e]
    counts: torch.Tensor        # [E] int64: rows routed to each expert
    capacity: int               # rows of the buffer (a bound, known on the host)
    tile_expert: Optional[torch.Tensor]  # [capacity / pad] int32: a tile's expert (pad > 1)
    n_tiles: Optional[torch.Tensor]      # [1] int32: the tiles in use (pad > 1)


def route(h: torch.Tensor, router: torch.Tensor, k: int):
    """h [T, D] -> (weights [T, k] f32, experts [T, k] int64): the softmax
    over h (f32) @ router [D, E] (f32), its k largest (greedy)."""
    return torch.topk(torch.softmax(h.float() @ router.float(), dim=-1), k, dim=-1)


def dispatch(idx: torch.Tensor, n_experts: int, pad: int = 1) -> Dispatch:
    """The routed rows of idx [T, k] sorted by expert (stable: a token's
    rows in token order), expert e's block at starts[e], a multiple of
    `pad`. With pad > 1 also each pad-row tile's expert and the number of
    tiles in use."""
    flat = idx.reshape(-1)
    R = flat.numel()
    dev = flat.device
    # scatter_add, not bincount: bincount on CUDA reads the largest id back
    counts = torch.zeros(n_experts, dtype=torch.int64, device=dev).scatter_add_(
        0, flat, torch.ones_like(flat))
    padded = (counts + pad - 1) // pad * pad if pad > 1 else counts
    ends = torch.cumsum(padded, 0)
    starts = F.pad(ends, (1, 0))
    first = ends - counts if pad == 1 else torch.cumsum(counts, 0) - counts  # unpadded starts
    sorted_e, order = torch.sort(flat, stable=True)
    rank = torch.arange(R, device=dev) - first[sorted_e]
    dest = torch.empty(R, dtype=torch.int64, device=dev)
    dest[order] = starts[sorted_e] + rank
    capacity = -(-(R + n_experts * (pad - 1)) // pad) * pad
    tile_expert = n_tiles = None
    if pad > 1:
        t0 = torch.arange(0, capacity, pad, device=dev)
        tile_expert = torch.searchsorted(ends, t0, right=True).clamp_(max=n_experts - 1).to(
            torch.int32)
        n_tiles = (ends[-1:] // pad).to(torch.int32)
    return Dispatch(dest, starts.to(torch.int32), counts, capacity, tile_expert, n_tiles)


def _expert_rows(d: Dispatch):
    """(expert, first row, row count) of each expert with rows (host sync:
    the plain versions only)."""
    starts, counts = d.starts.tolist(), d.counts.tolist()
    return [(e, starts[e], c) for e, c in enumerate(counts) if c]


# ------------------------------------------------------------- grouped W8A8

def grouped_w8a8_plain(xq, xs, w_t, ws, d: Dispatch, out_dtype=torch.bfloat16):
    """The grouped GEMM's maths an expert at a time: for expert e's rows of
    xq [capacity, K] int8 (scales xs [capacity, 1]), the exact int32 product
    with w_t[e]^T ([N, K] int8, K-major), rounded to f32, times xs, times
    ws[e] [N], cast to out_dtype. Rows of no expert (padding) are zero."""
    out = torch.zeros((xq.shape[0], w_t.shape[1]), dtype=out_dtype, device=xq.device)
    for e, s, c in _expert_rows(d):
        acc = _int8_dot(xq[s:s + c], w_t[e].t())
        out[s:s + c] = (acc.float() * xs[s:s + c] * ws[e]).to(out_dtype)
    return out


def grouped_w8a8(xq: torch.Tensor, xs: torch.Tensor, w_t: torch.Tensor, ws: torch.Tensor,
                 d: Dispatch) -> torch.Tensor:
    """xq [capacity, K] int8 and xs [capacity, 1] f32, each expert's rows at
    a multiple of 128 (dispatch(pad=W8A8_PAD)), times w_t [E, N, K] int8
    (K-major) and ws [E, N] f32 -> [capacity, N] bf16, rows of no expert
    left unwritten (zero on the CPU).

    A CPU tensor takes `grouped_w8a8_plain`; a CUDA tensor launches
    moe_w8a8_kernel (csrc/w8a8_gemm.cu) once: the dense GEMM's persistent
    grid walking (tile, column tile) over the tiles in use, each tile's
    weights those of its expert; bit-equal to the plain version."""
    if xq.device.type == "cpu":
        return grouped_w8a8_plain(xq, xs, w_t, ws, d)
    kernels.forbid_grad("moe_w8a8", xs, ws)
    M, K = xq.shape
    E, N = ws.shape
    dev = xq.device
    if not (
        M == d.capacity and M % W8A8_PAD == 0 and K % 16 == 0 and N % 16 == 0
        and w_t.shape == (E, N, K) and xs.shape == (M, 1) and d.tile_expert is not None
        and all(t.dtype == torch.int8 and t.device == dev and t.is_contiguous()
                and t.data_ptr() % 16 == 0 for t in (xq, w_t))
        and all(t.dtype == torch.float32 and t.device == dev and t.is_contiguous()
                for t in (xs, ws))
    ):
        raise ValueError(
            "moe_w8a8 kernel takes contiguous 16-byte-aligned int8 x [capacity % 128 == 0, "
            "K % 16 == 0] and w_t [E, N % 16 == 0, K], f32 scales [capacity, 1] and [E, N], "
            f"from dispatch(pad=128); got x {xq.dtype} {tuple(xq.shape)}, w_t {w_t.dtype} "
            f"{tuple(w_t.shape)}, xs {tuple(xs.shape)}, ws {tuple(ws.shape)}")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    fn = kernels.function(
        "w8a8_gemm", "moe_w8a8_gemm",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    err = fn(xq.data_ptr(), xs.data_ptr(), w_t.data_ptr(), ws.data_ptr(),
             d.tile_expert.data_ptr(), d.n_tiles.data_ptr(), out.data_ptr(), M, K, N, E,
             w8a8_tile_columns(M, N, _sm_count(dev)), kernels.stream_of(xq))
    kernels.check_launch("moe_w8a8", err)
    kernels.LAUNCHES["moe_w8a8"] += 1
    return out


# ------------------------------------------------------------ grouped W8A16

def grouped_w8a16_plain(x, w, ws, d: Dispatch):
    """K1's maths an expert at a time: expert e's rows of x [R, K] times
    w[e] [K, N] int8 widened, f32 sums, times ws[e], cast to x's type."""
    out = torch.zeros((x.shape[0], w.shape[-1]), dtype=x.dtype, device=x.device)
    for e, s, c in _expert_rows(d):
        out[s:s + c] = int8_matmul_plain(x[s:s + c], w[e], ws[e])
    return out


def grouped_w8a16(x: torch.Tensor, w: torch.Tensor, ws: torch.Tensor, d: Dispatch,
                  max_rows: int) -> torch.Tensor:
    """x [R, K] bf16, expert e's rows from starts[e] (dispatch(pad=1)),
    times w [E, K, N] int8 and ws [E, N] f32 -> [R, N] in x's type.
    `max_rows` bounds any expert's rows (the tokens: a token picks an
    expert once).

    A CPU tensor takes `grouped_w8a16_plain`; a CUDA tensor launches
    moe_w8a16_kernel (csrc/int8_matmul.cu) once: K1's block, its weight tile
    from the block's expert and its x rows that expert's; blocks of an
    expert with fewer rows return before reading anything."""
    if x.device.type == "cpu":
        return grouped_w8a16_plain(x, w, ws, d)
    kernels.forbid_grad("moe_w8a16", x, ws)
    R, K = x.shape
    E, N = ws.shape
    dev = x.device
    if not (
        R >= 1 and K % 8 == 0 and N % 16 == 0 and w.shape == (E, K, N)
        and x.dtype == torch.bfloat16 and w.dtype == torch.int8 and ws.dtype == torch.float32
        and all(t.device == dev and t.is_contiguous() for t in (x, w, ws))
        and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    ):
        raise ValueError(
            "moe_w8a16 kernel takes contiguous 16-byte-aligned bf16 x [R, K % 8 == 0], int8 w "
            f"[E, K, N % 16 == 0] and f32 ws [E, N]; got x {x.dtype} {tuple(x.shape)}, w "
            f"{w.dtype} {tuple(w.shape)}, ws {ws.dtype} {tuple(ws.shape)}")
    m_tiles = -(-max_rows // W8A16_MP)
    # the dense plan at as many 64-row tiles as the grid has (expert, tile) pairs
    plan = q8_plan(W8A16_MP * m_tiles * E, K, N, _sm_count(dev), q8_resident(dev))
    out = torch.empty((R, N), dtype=torch.bfloat16, device=dev)
    fn = kernels.function(
        "int8_matmul", "moe_w8a16",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    err = fn(x.data_ptr(), w.data_ptr(), ws.data_ptr(), d.starts.data_ptr(), out.data_ptr(),
             R, K, N, E, m_tiles, plan.splitk, kernels.stream_of(x))
    kernels.check_launch("moe_w8a16", err)
    kernels.LAUNCHES["moe_w8a16"] += 1
    return out


# ------------------------------------------------------------------ layer

def combine(y: torch.Tensor, d: Dispatch, weights: torch.Tensor, dtype) -> torch.Tensor:
    """Each token's k expert outputs (rows d.dest of y) times its router
    weights [T, k] in f32, summed, cast to `dtype`: [T, N]."""
    T, k = weights.shape
    return torch.bmm(weights[:, None], y[d.dest].view(T, k, -1).float())[:, 0].to(dtype)


def swiglu(h: torch.Tensor, gate, up, down) -> torch.Tensor:
    """A dense SwiGLU through ops.quant's dispatch (the shared experts)."""
    g, u = q8_apply_multi(h, (gate, up))
    return q8_apply(F.silu(g) * u, down)


def routed_experts(h: torch.Tensor, experts, weights: torch.Tensor, idx: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts' part of the layer for h [T, D] with the router's
    (weights, idx) [T, k]: dispatch, gate/up, SiLU x up, down, combine.
    Returns (that part [T, D], the rows routed to each expert [E] int64)."""
    T, k = idx.shape
    E = experts["gu"]["scale"].shape[0]
    Fw = experts["down"]["q8"].shape[1]
    if T * k / E > KERNEL_MAX_M and _w8a8_enabled(h.device):
        d = dispatch(idx, E, W8A8_PAD)
        hq, hs = quantize_rows(h)
        tok = d.dest.new_empty(d.capacity).zero_()
        tok[d.dest] = torch.arange(T * k, device=h.device) // k
        xq, xs = hq[tok], torch.zeros((d.capacity, 1), dtype=torch.float32, device=h.device)
        xs[d.dest] = hs.repeat_interleave(k, 0)
        gu = grouped_w8a8(xq, xs, experts["gu_t"], experts["gu"]["scale"], d)
        a = F.silu(gu[:, :Fw]) * gu[:, Fw:]
        aq, as_ = quantize_rows(a)
        y = grouped_w8a8(aq, as_, experts["down_t"], experts["down"]["scale"], d)
    else:
        d = dispatch(idx, E, 1)
        x = h.new_empty((d.capacity, h.shape[-1]))
        x[d.dest] = h.repeat_interleave(k, 0)
        gu = grouped_w8a16(x, experts["gu"]["q8"], experts["gu"]["scale"], d, T)
        a = F.silu(gu[:, :Fw]) * gu[:, Fw:]
        y = grouped_w8a16(a, experts["down"]["q8"], experts["down"]["scale"], d, T)
    return combine(y, d, weights, h.dtype), d.counts


def moe_counters(rows: int, k: int, counts: torch.Tensor):
    """The span `model.moe`'s counters of a layer over `rows` tokens whose
    routed rows per expert are `counts` [E]: rows, routed_rows, and
    max_expert_rows and experts_hit as device scalars (utils/spans.py reads
    them with the records)."""
    return {"rows": rows, "routed_rows": rows * k, "max_expert_rows": counts.max(),
            "experts_hit": (counts > 0).sum()}


def moe_block(cfg, mp, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepseekV2MoE on x [..., D] with one MoE layer's params mp
    ({"router" [D, E] f32, "experts", "shared_gate", "shared_up",
    "shared_down"}): the routed experts plus the shared experts. Returns
    (the output, shaped as x, the rows routed to each expert [E] int64)."""
    h = x.reshape(-1, x.shape[-1])
    weights, idx = route(h, mp["router"], cfg.num_experts_per_tok)
    y, counts = routed_experts(h, mp["experts"], weights, idx)
    y = y + swiglu(h, mp["shared_gate"], mp["shared_up"], mp["shared_down"])
    return y.reshape(x.shape), counts
