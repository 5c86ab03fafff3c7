"""Int8 weight quantization and the quantized matmul dispatch.

Counterpart of revisionllm_tpu/ops/quant.py. Per-output-channel absmax int8
weights halve the weight bytes of the memory-bound decode step. `q8_apply`
keeps JAX's dispatch rule (ops/quant.py:237-276):

- M <= 256 (every decode matmul): `int8_matmul`, kernel K1
  (csrc/int8_matmul.cu) on a CUDA tensor, its plain version on a CPU one;
- M > 256 with W8A8 on (prefill): `w8a8_matmul`, per-row int8 activations
  times int8 weights with int32 accumulation. In JAX this is an XLA int8 dot
  outside any Pallas kernel. Here a CUDA tensor takes three hand-written
  launches (csrc/w8a8_gemm.cu): `quantize_rows` once for the matrices that
  share x, then per matrix a transpose of the weight and the int8 wgmma GEMM
  (`w8a8_gemm`), whose epilogue applies both scales and the cast; a CPU
  tensor takes their plain versions (`torch._int_mm`). Its gradient is JAX's
  straight-through rule (:162-190): dx = g dequant(W)^T as if the matmul
  were exact;
- otherwise exact dequantization, then a matmul.

Int4 weights ({"q4", "scale4"}, group-wise, two nibbles a byte) take
`q4_apply`: row 7 (`int4_matmul`, csrc/int4_matmul.cu) at M <= 256 or with
REVISIONLLM_Q4_PALLAS=all, else dequantize-then-matmul. The fused W8A8 MLP
tail (`w8a8_mlp_fused`, row 8, csrc/w8a8_mlp_fused.cu) and
`w8a8_prequant_matmul` serve models/llama.py's REVISIONLLM_FUSED_MLP branch.
The serving-packed layout of ops/decode_serve.py ({"q8c"} column chunks,
{"q8r"} row chunks) takes `q8c_apply`, the same three routes per chunk;
`q8_apply_multi` sends it matrix by matrix, as JAX does.

`set_exact_trace(True)` (the trainer's `_dequant_trace`) sends every call to
the differentiable dequantize-then-matmul route, on any device and any M, as
JAX's exact-trace rule does (:221-234). K1 and the W8A8 kernels have no
backward: on a CUDA tensor that requires grad they raise (`forbid_grad`)
rather than cut it from the graph.

Quantization divides and rounds half to even (`torch.round`, like
`jnp.round`), so the int8 values are bit-equal to JAX's.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from revisionllm_tpu_torch.utils import kernels

KERNEL_MAX_M = 256  # q8_apply sends M <= 256 rows to K1, as JAX's pallas_max_m


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w: [..., K, N] -> (int8 values [..., K, N], f32 scales [..., N])."""
    wf = w.float()
    absmax = wf.abs().amax(dim=-2)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale.unsqueeze(-2)), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale.unsqueeze(-2)).to(dtype)


def int8_matmul_plain(x: torch.Tensor, w_q8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K1's maths step by step: widen int8 to f32 (exact), multiply with f32
    accumulation, apply the per-column scale, cast to x's type."""
    K, N = w_q8.shape
    x2 = x.reshape(-1, K)
    acc = x2.float() @ w_q8.float()
    return (acc * scale).to(x.dtype).reshape(*x.shape[:-1], N)


# ---------------------------------------------------------------------------
# The weight-only decode matmuls (K1 and row 7): launch planning they share
# ---------------------------------------------------------------------------

WONLY_MP = 64                 # x rows of a block (the grid's z axis walks more)
WONLY_BN = 128                # output columns of a block
WONLY_SPLITS = (1, 2, 4, 8)   # cluster sizes along K (8: the portable limit)


class SplitPlan(NamedTuple):
    m_tiles: int   # blocks of 64 rows (the grid's z axis)
    n_tiles: int   # blocks of 128 columns (x axis)
    splitk: int    # K ranks, one cluster (y axis)
    k_tiles: int   # 128-row K tiles


@functools.lru_cache(maxsize=None)
def split_plan(M: int, k_tiles: int, N: int, sms: int, resident: Tuple[int, ...]) -> SplitPlan:
    """The launch of a weight-only decode matmul (K1 and row 7 share the
    geometry: blocks of 64 rows x 128 columns, K in 128-row tiles) for M <=
    256 rows on a card of `sms` SMs, where resident[i] clusters of
    WONLY_SPLITS[i] blocks fit at once (the kernel's
    cudaOccupancyMaxActiveClusters; several blocks share an SM).

    Each block takes 64 rows (more rows take the grid's z axis). The K
    splits S of a column tile form one cluster; S is the one of 1, 2, 4, 8
    (at most the tile count) with the least modelled time, the smaller on a
    tie: waves of resident clusters x (tiles a rank + 2, a block's fixed
    cost: the ring's first tile and the sums) x (b + 1) / 2 for b blocks
    sharing the busiest SM (co-resident blocks hide part of each other's
    latency, so b of them take less than b times one). Fitted to the
    splits timed by scripts/torch_int4_probe.py at row 7's decode shapes;
    at K1's it picks the splits scripts/torch_int8_kernel.py timed
    fastest too."""
    m_tiles = -(-M // WONLY_MP)
    n_tiles = -(-N // WONLY_BN)

    def cost(i):
        s = WONLY_SPLITS[i]
        clusters = n_tiles * m_tiles
        waves = -(-clusters // max(1, resident[i]))
        per_sm = -(-(-(-clusters // waves) * s) // sms)
        return waves * (-(-k_tiles // s) + 2) * (per_sm + 1)

    i = min((i for i, s in enumerate(WONLY_SPLITS) if s <= k_tiles),
            key=lambda i: (cost(i), WONLY_SPLITS[i]))
    return SplitPlan(m_tiles, n_tiles, WONLY_SPLITS[i], k_tiles)


def rank_tiles(k_tiles: int, splitk: int) -> List[Tuple[int, int]]:
    """(first tile, tile count) of each K rank, as K1 and row 7 split them:
    whole tiles, the first k_tiles % splitk ranks one tile more."""
    base, rem = divmod(k_tiles, splitk)
    return [(r * base + min(r, rem), base + (r < rem)) for r in range(splitk)]


_RESIDENT: Dict[tuple, Tuple[int, ...]] = {}
_SMS: Dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def _resident(name: str, symbol: str, device: torch.device) -> Tuple[int, ...]:
    """How many clusters of each of WONLY_SPLITS kernel `name` fits on
    `device` at once (asked of its library's `symbol` once, then cached)."""
    res = _RESIDENT.get((name, device.index))
    if res is None:
        fn = kernels.function(name, symbol, [ctypes.c_int])
        res = tuple(fn(s) for s in WONLY_SPLITS)
        if min(res) < 1:
            raise RuntimeError(f"{name}: clusters of {WONLY_SPLITS} blocks fit {res} times")
        _RESIDENT[(name, device.index)] = res
    return res


# K1's tile geometry, mirrored from csrc/int8_matmul.cu
Q8_BN = WONLY_BN           # output columns of a block (one consumer warpgroup)
Q8_BK = 128                # K rows of a tile (the last may run past K: zeros)
Q8_MP = WONLY_MP           # x rows of a block
Q8_STAGES = 2              # ring stages


def q8_smem_bytes() -> int:
    """A block's dynamic shared memory (csrc/int8_matmul.cu, SMEM): the ring
    of Q8_STAGES stages, each x (Q8_MP x Q8_BK bf16) and W (Q8_BK x Q8_BN
    int8), both 128-byte swizzled, which the f32 partial tile (Q8_MP x
    (Q8_BN + 4)) reuses at the end; a full and an empty 8-byte mbarrier a
    stage; 1 KB for the ring's 1024-byte alignment."""
    ring = Q8_STAGES * (Q8_MP * Q8_BK * 2 + Q8_BK * Q8_BN)
    return max(ring, Q8_MP * (Q8_BN + 4) * 4) + 2 * Q8_STAGES * 8 + 1024


def q8_plan(M: int, K: int, N: int, sms: int, resident: Tuple[int, ...]) -> SplitPlan:
    """K1's launch for M <= 256 rows: `split_plan` over the Q8_BK-row tiles
    of K (the last zero-filled past K) and Q8_BN-column blocks."""
    return split_plan(M, -(-K // Q8_BK), N, sms, resident)


def q8_resident(device: torch.device) -> Tuple[int, ...]:
    """How many clusters of each of WONLY_SPLITS K1 fits on `device` at once."""
    return _resident("int8_matmul", "q8_matmul_max_clusters", device)


def int8_matmul(x: torch.Tensor, w_q8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x: [..., K] (bf16 on the card); w_q8: [K, N] int8; scale: [N] f32 ->
    [..., N] in x's type. Leading dims of x flatten into M <= 256.

    A CPU tensor takes `int8_matmul_plain`; a CUDA tensor launches K1
    (csrc/int8_matmul.cu) once, with the split that `q8_plan` picks, and
    allocates only the output."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w_q8, scale)
    kernels.forbid_grad("int8_matmul", x, scale)
    K, N = w_q8.shape
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    dev = x.device
    if not (
        1 <= M <= KERNEL_MAX_M and K % 8 == 0 and N % 16 == 0 and scale.shape == (N,)
        and x2.dtype == torch.bfloat16 and w_q8.dtype == torch.int8
        and scale.dtype == torch.float32 and w_q8.device == dev and scale.device == dev
        and x2.is_contiguous() and w_q8.is_contiguous() and scale.is_contiguous()
        and x2.data_ptr() % 16 == 0 and w_q8.data_ptr() % 16 == 0
    ):
        raise ValueError(
            "int8_matmul kernel takes contiguous 16-byte-aligned bf16 x [M<=256, K%8==0], "
            f"int8 w [K, N%16==0] and f32 scale [N] on one device; got x {x2.dtype} "
            f"{tuple(x2.shape)}, w {w_q8.dtype} {tuple(w_q8.shape)}, scale {scale.dtype} "
            f"{tuple(scale.shape)}"
        )
    plan = q8_plan(M, K, N, _sm_count(dev), q8_resident(dev))
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    fn = kernels.function(
        "int8_matmul", "q8_matmul_bf16",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    )
    err = fn(
        x2.data_ptr(), w_q8.data_ptr(), scale.data_ptr(), out.data_ptr(),
        M, K, N, plan.splitk, kernels.stream_of(x2),
    )
    kernels.check_launch("int8_matmul", err)
    kernels.LAUNCHES["int8_matmul"] += 1
    return out.reshape(*x.shape[:-1], N)


def row_absmax(x: torch.Tensor) -> torch.Tensor:
    """The f32 absmax of each row of [..., K] as [M, 1] (abs and max are
    exact in x's own type)."""
    return x.reshape(-1, x.shape[-1]).abs().amax(dim=-1, keepdim=True).float()


def quantize_rows_plain(x: torch.Tensor, absmax: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax int8 over the last axis of [..., K] -> (int8 [..., K],
    f32 scale [..., 1]): scale = absmax / 127 (1 where it is 0), q =
    clip(round(x / scale), -127, 127), the quotient in f32 and rounded half
    to even. `absmax` [..., 1], when given, replaces the rows' own. (On a
    CUDA tensor PyTorch divides by the scalar 127 as a product with its f32
    reciprocal, so a scale may differ from the CPU's in its last bit.)"""
    if absmax is None:
        absmax = x.abs().amax(dim=-1, keepdim=True).float()
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    # x / scale promotes to f32: the same quotient as x.float() / scale
    return torch.div(x, scale).round_().clamp_(-127, 127).to(torch.int8), scale


QROWS_MAX_K = 16384  # csrc/w8a8_gemm.cu quantize_rows: 256 threads x 8 vectors of 8


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`quantize_rows_plain` of [..., K] (its own absmax): (int8 [..., K],
    f32 scale [..., 1]), the W8A8 prefill's activations and the int8 prompt
    cache's rows of head_dim.

    A CPU tensor takes `quantize_rows_plain`; a CUDA tensor launches
    quantize_rows_kernel (csrc/w8a8_gemm.cu) once, bit-equal to the plain
    version on the card: bf16, K % 8 == 0 and K <= QROWS_MAX_K."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x)
    kernels.forbid_grad("quantize_rows", x)
    K = x.shape[-1]
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    if not (x2.dtype == torch.bfloat16 and K % 8 == 0 and 8 <= K <= QROWS_MAX_K):
        raise ValueError(
            f"quantize_rows kernel takes bf16 rows of K % 8 == 0, 8 <= K <= {QROWS_MAX_K}; got "
            f"{x2.dtype} {tuple(x.shape)}")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    if M == 0:
        return q, s
    if x2.data_ptr() % 16:
        x2 = x2.clone()  # a view at an odd offset: 16-byte loads need an aligned row
    fn = kernels.function("w8a8_gemm", "quantize_rows",
                          [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    err = fn(x2.data_ptr(), q.data_ptr(), s.data_ptr(), M, K, kernels.stream_of(x2))
    kernels.check_launch("quantize_rows", err)
    kernels.LAUNCHES["quantize_rows"] += 1
    return q, s


def quantize_activation_rows(x: torch.Tensor, absmax: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax int8 of [..., K] -> (int8 [M, K], f32 scale [M, 1]):
    the dynamic-activation half of W8A8 (JAX's quantize_activation_rows),
    through `quantize_rows`. `absmax` [M, 1], when given, replaces the rows'
    own (a row-parallel slice quantized by its whole row's absmax; the plain
    route)."""
    x2 = x.reshape(-1, x.shape[-1])
    if absmax is None:
        return quantize_rows(x2)
    return quantize_rows_plain(x2, absmax)


def _int8_dot(x_q8: torch.Tensor, w_q8: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 x [M, K] and int8 w [K, N]: the CPU's W8A8
    route, the int32 partial sums of the row-parallel W8A8 product under
    tensor parallelism, and row 8's plain version. On the card
    torch._int_mm wants M > 16 (fewer rows are padded to 17) and takes
    cuBLAS's fast int8 kernel only for a column-major weight, so the weight
    is transposed for the call (the stored layout stays [K, N] row-major, as
    in JAX)."""
    M = x_q8.shape[0]
    if x_q8.is_cuda:
        xp = torch.nn.functional.pad(x_q8, (0, 0, 0, 17 - M)) if M <= 16 else x_q8
        return torch._int_mm(xp, w_q8.t().contiguous().t())[:M]
    if M > 16:
        return torch._int_mm(x_q8, w_q8)
    return x_q8.int() @ w_q8.int()


W8A8_BM = 128  # the GEMM's tile (csrc/w8a8_gemm.cu): 128 rows by 128 or 256 columns


def w8a8_tile_columns(M: int, N: int, sms: int) -> int:
    """The GEMM's tile width in 128 columns for an [M, K] x [K, N] product
    on `sms` SMs: 2, unless its tiles would not fill two waves, where the
    narrow tile spreads the work over more SMs (ChatGLM2's k and v, N 256,
    152 wide tiles). The copies bound the narrow tile sooner: it moves two
    thirds of the wide one's bytes for half its products, and at the cells'
    other shapes it ran 11-20 points further from the bound (PERF.md)."""
    wide = -(-M // W8A8_BM) * -(-N // 256)
    return 2 if wide >= 2 * sms else 1


def _w8a8_out_ok(out: torch.Tensor, M: int, N: int, dev: torch.device) -> bool:
    """Whether the GEMM can write `out`: [M, N] on `dev`, unit column stride;
    bf16 goes out in TMA boxes (16-byte aligned, row stride a multiple of
    8), f32 in float2 stores (8-byte aligned, even row stride)."""
    step, align = (8, 16) if out.dtype == torch.bfloat16 else (2, 8)
    return (out.shape == (M, N) and out.device == dev and out.stride(1) == 1
            and out.stride(0) >= N and out.stride(0) % step == 0 and out.data_ptr() % align == 0)


def w8a8_gemm_plain(x_q8, x_scale, w_q8, w_scale, out_dtype=torch.bfloat16):
    """The GEMM's maths step by step: the exact int32 product, each sum
    rounded to f32, times x_scale, times w_scale (two f32 roundings, in that
    order), cast to out_dtype."""
    return (_int8_dot(x_q8, w_q8).float() * x_scale * w_scale).to(out_dtype)


def w8a8_gemm(x_q8: torch.Tensor, x_scale: torch.Tensor, w_q8: torch.Tensor,
              w_scale: torch.Tensor, out: Optional[torch.Tensor] = None,
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """(x_q8 [M, K] int8, x_scale [M, 1] f32) x (w_q8 [K, N] int8, w_scale [N]
    f32) -> ((x_q8 @ w_q8 in f32) * x_scale) * w_scale as [M, N] of
    out_dtype, or written into `out` ([M, N], unit column stride, any row
    stride: a column slice of a wider output) and returned.

    A CPU tensor takes `w8a8_gemm_plain`; a CUDA tensor launches, on the
    caller's stream, kmajor_transpose_kernel (the weight K-major into a
    scratch [N, K]) and then s8gemm_kernel once (csrc/w8a8_gemm.cu), whose
    epilogue applies both scales and the cast: bit-equal to the plain
    version, bf16 or f32 out, K and N multiples of 16."""
    if x_q8.device.type == "cpu":
        res = w8a8_gemm_plain(x_q8, x_scale, w_q8, w_scale,
                              torch.float32 if out is not None else out_dtype)
        return res if out is None else out.copy_(res)
    kernels.forbid_grad("w8a8_gemm", x_scale, w_scale)
    M, K = x_q8.shape
    N = w_q8.shape[-1]
    dev = x_q8.device
    dtype = out_dtype if out is None else out.dtype
    if not (
        M >= 1 and K % 16 == 0 and N % 16 == 0 and w_q8.shape == (K, N)
        and x_scale.shape == (M, 1) and w_scale.shape == (N,)
        and dtype in (torch.bfloat16, torch.float32)
        and all(t.dtype == torch.int8 and t.device == dev and t.is_contiguous()
                and t.data_ptr() % 16 == 0 for t in (x_q8, w_q8))
        and all(t.dtype == torch.float32 and t.device == dev and t.is_contiguous()
                for t in (x_scale, w_scale))
        and (out is None or _w8a8_out_ok(out, M, N, dev))
    ):
        raise ValueError(
            "w8a8_gemm kernel takes contiguous 16-byte-aligned int8 x [M, K%16==0] and w [K, "
            "N%16==0], f32 scales [M, 1] and [N] on one device, and a bf16 or f32 output [M, N] "
            "(unit column stride; bf16: 16-byte aligned, row stride a multiple of 8; f32: "
            f"8-byte aligned, even row stride); got x {x_q8.dtype} {tuple(x_q8.shape)}, "
            f"w {w_q8.dtype} {tuple(w_q8.shape)}, x_scale {tuple(x_scale.shape)}, w_scale "
            f"{tuple(w_scale.shape)}, out {dtype}"
            + ("" if out is None else f" {tuple(out.shape)} stride {out.stride()}"))
    if out is None:
        out = torch.empty((M, N), dtype=dtype, device=dev)
    wt = torch.empty((N, K), dtype=torch.int8, device=dev)
    fn = kernels.function(
        "w8a8_gemm", "w8a8_gemm",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 2
        + [ctypes.c_void_p])
    err = fn(x_q8.data_ptr(), x_scale.data_ptr(), w_q8.data_ptr(), w_scale.data_ptr(),
             wt.data_ptr(), out.data_ptr(), M, K, N, out.stride(0),
             int(dtype == torch.float32), w8a8_tile_columns(M, N, _sm_count(dev)),
             kernels.stream_of(x_q8))
    kernels.check_launch("w8a8_gemm", err)
    kernels.LAUNCHES["w8a8_transpose"] += 1
    kernels.LAUNCHES["w8a8_gemm"] += 1
    return out


def _w8a8_product(
    x: torch.Tensor, x_q8: torch.Tensor, x_scale: torch.Tensor,
    w_q8: torch.Tensor, w_scale: torch.Tensor, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One W8A8 product in x's type and leading shape, or written into `out`
    ([M, N] of x's type, a column slice of a wider output) with the same
    rounding: `w8a8_gemm`."""
    res = w8a8_gemm(x_q8, x_scale, w_q8, w_scale, out=out, out_dtype=x.dtype)
    return res if out is not None else res.reshape(*x.shape[:-1], res.shape[-1])


class _W8A8Product(torch.autograd.Function):
    """One shared activation quantization of x times several int8 matrices,
    with JAX's straight-through VJP: the rounding in the quantization has a
    zero derivative, so the backward is dx = sum_i g_i dequant(W_i)^T in f32,
    cast to the cotangent's type, as if each product were exact
    (revisionllm_tpu/ops/quant.py:181-187, :335-343, :374-380). With `concat`
    the products are written side by side into one [..., sum N_i] output (the
    column chunks of q8c_apply) instead of returned one by one."""

    @staticmethod
    def forward(ctx, x, concat, *weights):
        x_q8, x_scale = quantize_activation_rows(x)
        pairs = list(zip(weights[0::2], weights[1::2]))
        ctx.save_for_backward(*weights)
        ctx.widths = [wq.shape[-1] for wq, _ in pairs] if concat else None
        if not concat:
            return tuple(_w8a8_product(x, x_q8, x_scale, wq, ws) for wq, ws in pairs)
        out = torch.empty((x_q8.shape[0], sum(ctx.widths)), dtype=x.dtype, device=x.device)
        for (wq, ws), part in zip(pairs, out.split(ctx.widths, dim=-1)):
            _w8a8_product(x, x_q8, x_scale, wq, ws, out=part)
        return out.reshape(*x.shape[:-1], out.shape[-1])

    @staticmethod
    def backward(ctx, *gs):
        weights = ctx.saved_tensors
        if ctx.widths is not None:
            gs = gs[0].split(ctx.widths, dim=-1)
        gx = None
        for g, wq, ws in zip(gs, weights[0::2], weights[1::2]):
            if g is None:
                continue
            w = dequantize_int8(wq, ws, torch.float32)
            part = g.float() @ w.T
            gx = part if gx is None else gx + part
        if gx is not None:
            gx = gx.to(next(g for g in gs if g is not None).dtype)
        return (gx, None) + (None,) * len(weights)


def w8a8_matmul_absmax(x: torch.Tensor, w_q8: torch.Tensor, w_scale: torch.Tensor,
                       absmax: torch.Tensor, reduce) -> torch.Tensor:
    """w8a8_matmul with the activation rows quantized by `absmax` [M, 1]
    instead of their own, and `reduce` applied to the int32 product before
    the scales (a row-parallel slice's partial sums, added exactly across
    ranks, give one process's product bit for bit); serving only (no
    gradient)."""
    x_q8, x_scale = quantize_activation_rows(x, absmax)
    if x_q8.is_cuda:
        kernels.forbid_grad("torch._int_mm (W8A8)", x, x_scale, w_scale)
    return _w8a8_scale(reduce(_int8_dot(x_q8, w_q8).contiguous()), x, x_scale, w_scale)


def _w8a8_scale(acc: torch.Tensor, x: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """The int32 product acc [M, N] scaled as _w8a8_product does, in x's
    type and leading shape."""
    out = torch.mul(acc, x_scale)  # int32 -> f32 rounding as acc.float()
    out.mul_(w_scale)
    return out.to(x.dtype).reshape(*x.shape[:-1], acc.shape[-1])


def w8a8_matmul(x: torch.Tensor, w_q8: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """Dynamic-activation int8 matmul: per-row absmax quantize x, int8 x int8
    with int32 accumulation, rescale. Straight-through gradient to x."""
    return _W8A8Product.apply(x, False, w_q8, w_scale)[0]


_W8A8: Optional[bool] = None


def set_w8a8(enabled: Optional[bool]) -> None:
    """Override the W8A8-prefill switch (None = back to the environment and
    the device default)."""
    global _W8A8
    _W8A8 = enabled


def _w8a8_enabled(device: torch.device) -> bool:
    """W8A8 prefill: set_w8a8, else REVISIONLLM_W8A8=0/1, else ON for CUDA
    tensors (serving numerics) and OFF on the CPU (exact parity), as JAX
    defaults it ON for the TPU and OFF on the CPU."""
    if _W8A8 is not None:
        return _W8A8
    env = os.environ.get("REVISIONLLM_W8A8")
    if env is not None:
        return env == "1"
    return device.type == "cuda"


_EXACT_TRACE = False


def set_exact_trace(enabled: bool) -> None:
    """While set, q8_apply and q8_apply_multi take the differentiable
    dequantize-then-matmul route: no K1 and no W8A8, on any device and any M
    (the trainer sets it around a loss, as JAX's _dequant_trace does)."""
    global _EXACT_TRACE
    _EXACT_TRACE = bool(enabled)


def _is_q8(w) -> bool:
    return isinstance(w, dict) and "q8" in w


def w8a8_route(x: torch.Tensor, w) -> bool:
    """Whether q8_apply(x, w) takes the W8A8 route."""
    return (_is_q8(w) and not _EXACT_TRACE and x.numel() // x.shape[-1] > KERNEL_MAX_M
            and _w8a8_enabled(x.device))


def q8_apply(x: torch.Tensor, w) -> torch.Tensor:
    """Matmul dispatch: w is a dense [K, N] tensor, a {'q8', 'scale'} dict,
    an int4 {'q4', 'scale4'} dict (q4_apply) or a serving-packed chunk dict
    ({'q8c'} or {'q8r'}, q8c_apply)."""
    if isinstance(w, dict) and "q4" in w:
        return q4_apply(x, w)
    if isinstance(w, dict) and ("q8c" in w or "q8r" in w):
        return q8c_apply(x, w)
    if not _is_q8(w):
        return x @ w
    if _EXACT_TRACE:
        return x @ dequantize_int8(w["q8"], w["scale"], x.dtype)
    M = x.numel() // x.shape[-1]
    if M <= KERNEL_MAX_M:
        return int8_matmul(x, w["q8"], w["scale"])
    if _w8a8_enabled(x.device):
        return w8a8_matmul(x, w["q8"], w["scale"])
    return x @ dequantize_int8(w["q8"], w["scale"], x.dtype)


def q8_apply_multi(x: torch.Tensor, ws: Sequence):
    """Apply several matrices to the SAME activation, sharing one activation
    quantization on the W8A8 path (bit-exact vs separate w8a8_matmul calls,
    with the summed straight-through gradient); per-matrix q8_apply
    otherwise (int4 weights included, as JAX's :296-313), and always under
    the exact trace."""
    ws = tuple(ws)
    M = x.numel() // x.shape[-1]
    if not (
        len(ws) >= 2 and all(_is_q8(w) for w in ws) and not _EXACT_TRACE
        and M > KERNEL_MAX_M and _w8a8_enabled(x.device)
    ):
        return tuple(q8_apply(x, w) for w in ws)
    return _W8A8Product.apply(x, False, *(t for w in ws for t in (w["q8"], w["scale"])))


# ---------------------------------------------------------------------------
# The serving-packed layout (ops/decode_serve.py): column and row chunks
# ---------------------------------------------------------------------------


def q8c_apply(x: torch.Tensor, w) -> torch.Tensor:
    """q8_apply over the serving-packed layout (revisionllm_tpu/ops/quant.py:
    386-440).

    - {'q8c': [nc, K, BN], 'scale': [Np]} column chunks: at M <= 256 one
      `int8_matmul` (K1) per chunk, concatenated; above that W8A8 over the
      chunks when it is on (one shared activation quantization, one
      product per chunk into its columns of one output, bit-equal to
      `w8a8_matmul` on the unpacked weight), else exact dequantization. The
      exact route rounds the scale to x's type before the product, as JAX's
      does (`q8c.astype(x.dtype) * scale.astype(x.dtype)`), which in bf16 is
      not the standard route's f32 product. Padded columns carry zero scale,
      so the outputs past the logical N are exactly 0.
    - {'q8r': [ncf, BF, N], 'scale': [N]} row chunks: the padded [Fp, N]
      matrix through the standard dispatch (x carries Fp columns; zero rows
      add nothing).

    `set_exact_trace(True)` sends every call to the exact route."""
    if "q8r" in w:
        q8r = w["q8r"]
        return q8_apply(x, {"q8": q8r.reshape(-1, q8r.shape[-1]), "scale": w["scale"]})
    q8c, scale = w["q8c"], w["scale"]
    nc, K, BN = q8c.shape
    M = x.numel() // x.shape[-1]
    if not _EXACT_TRACE and M <= KERNEL_MAX_M:
        return torch.cat([int8_matmul(x, q8c[j], scale[j * BN:(j + 1) * BN]) for j in range(nc)],
                         dim=-1)
    scale_r = scale.reshape(nc, BN)
    if not _EXACT_TRACE and _w8a8_enabled(x.device):
        return _W8A8Product.apply(x, True, *(t for j in range(nc) for t in (q8c[j], scale_r[j])))
    wf = q8c.to(x.dtype) * scale_r[:, None, :].to(x.dtype)
    out = torch.matmul(x.reshape(1, M, K), wf)  # [nc, M, BN]
    return out.permute(1, 0, 2).reshape(*x.shape[:-1], nc * BN)


def pack_serving_weights_host(layers: dict, block_n: int = 1024, block_f: int = 1024) -> dict:
    """Host-RAM (NumPy) front of ops.decode_serve.pack_serving_weights for
    the loader (revisionllm_tpu/ops/quant.py:443-486): the arrays go through
    the same packer as CPU tensors and come back as arrays, so the packed
    copy never sits beside the standard one on the card."""
    import numpy as np

    from revisionllm_tpu_torch.ops.decode_serve import pack_serving_weights

    def cpu(w):
        arrays = {k: np.asarray(v) for k, v in w.items()}
        return {k: torch.from_numpy(a if a.flags.writeable else a.copy())
                for k, a in arrays.items()}

    packed = pack_serving_weights({n: cpu(w) if isinstance(w, dict) else w
                                   for n, w in layers.items()}, block_n, block_f)
    return {n: {k: v.numpy() for k, v in w.items()} if isinstance(w, dict) else w
            for n, w in packed.items()}


def quantize_llama_params_host(params, quantize_lm_head: bool = True):
    """Host-RAM variant of quantize_llama_params, for a converted checkpoint
    before any device transfer (revisionllm_tpu/ops/quant.py:489): NumPy
    arrays in, {"q8": int8, "scale": f32} arrays out. The arithmetic is
    JAX's NumPy arithmetic (f32 absmax / 127, division, round half to even,
    clip) to the bit, run by torch on the CPU's cores."""
    import numpy as np

    def q(w):
        wf = torch.from_numpy(np.array(w, dtype=np.float32))
        absmax = wf.abs().amax(dim=-2)
        scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
        vals = wf.div_(scale[..., None, :]).round_().clamp_(-127, 127).to(torch.int8)
        return {"q8": vals.numpy(), "scale": scale.numpy()}

    out = dict(params)
    layers = {}
    for name, w in params["layers"].items():
        if name.endswith("_norm") or name.endswith("_bias") or (
            hasattr(w, "ndim") and w.ndim < 3
        ):
            layers[name] = w
        else:
            layers[name] = q(w)
    out["layers"] = layers
    if quantize_lm_head and not isinstance(params["lm_head"], dict):
        out["lm_head"] = q(params["lm_head"])
    return out


def quantize_llama_params(params, quantize_lm_head: bool = True):
    """Quantize all stacked layer matrices (and optionally lm_head) of a
    models/llama param tree to int8. Norms and embed keep their type."""
    out = dict(params)
    layers = {}
    for name, w in params["layers"].items():
        if name.endswith("_norm"):
            layers[name] = w
        else:
            q, s = quantize_int8(w)
            layers[name] = {"q8": q, "scale": s}
    out["layers"] = layers
    if quantize_lm_head:
        q, s = quantize_int8(params["lm_head"])
        out["lm_head"] = {"q8": q, "scale": s}
    return out


# ---------------------------------------------------------------------------
# Int4 (W4A16): group-wise weights, two nibbles a byte; kernel row 7
# ---------------------------------------------------------------------------

Q4_GROUP = 128


def quantize_int4(w: torch.Tensor, group: int = Q4_GROUP) -> Tuple[torch.Tensor, torch.Tensor]:
    """w: [..., K, N] -> (uint8 [..., K//2, N], f32 scales [..., K//group, N]).

    Group-wise absmax along K per output column, int4 range [-7, 7]; rows 2i
    (low nibble) and 2i+1 (high nibble) pack into byte i, as JAX's
    quantize_int4."""
    K, N = w.shape[-2], w.shape[-1]
    if K % group or K % 2:
        raise ValueError(f"K={K} must be a multiple of the group {group} and of 2")
    wf = w.float().reshape(*w.shape[:-2], K // group, group, N)
    absmax = wf.abs().amax(dim=-2)
    scale = torch.where(absmax > 0, absmax / 7.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale.unsqueeze(-2)), -7, 7).to(torch.int32)
    q = q.reshape(*w.shape[:-2], K, N)
    packed = (q[..., 0::2, :] & 0xF) | ((q[..., 1::2, :] & 0xF) << 4)
    return packed.to(torch.uint8), scale


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [..., K//2, N] -> int8 [..., K, N] in [-8, 7]: each nibble
    moved to the top of an int8 and shifted back arithmetically, which
    sign-extends it (JAX's unpack_int4 returns the same values as int32)."""
    lo = (packed << 4).view(torch.int8) >> 4
    hi = packed.view(torch.int8) >> 4
    K2, N = packed.shape[-2], packed.shape[-1]
    return torch.stack([lo, hi], dim=-2).reshape(*packed.shape[:-2], 2 * K2, N)


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16,
                    group: int = Q4_GROUP) -> torch.Tensor:
    """q * scale per group in f32, rounded once to `dtype`."""
    q = unpack_int4(packed)
    K, N = q.shape[-2], q.shape[-1]
    qg = q.reshape(*q.shape[:-2], K // group, group, N).float()
    return (qg * scale.unsqueeze(-2)).reshape(*q.shape[:-2], K, N).to(dtype)


def int4_matmul_plain(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor,
                      group: int = Q4_GROUP) -> torch.Tensor:
    """Row 7's maths step by step: the weight q * scale rounded to x's type
    (as the Pallas body does before its dot, quant.py:603-607), then the
    product with f32 accumulation, cast to x's type."""
    w = dequantize_int4(w_packed, scale, x.dtype, group)
    K, N = w.shape
    acc = x.reshape(-1, K).float() @ w.float()
    return acc.to(x.dtype).reshape(*x.shape[:-1], N)


# Row 7's tile geometry, mirrored from csrc/int4_matmul.cu
Q4_BN = WONLY_BN           # output columns of a block (one warpgroup)
Q4_BK = 128                # K rows of a tile (64 packed rows, one scale group)
Q4_MP = WONLY_MP           # x rows of a block
Q4_STAGES = 2              # ring stages


def q4_smem_bytes() -> int:
    """A block's dynamic shared memory (csrc/int4_matmul.cu, SMEM): the ring
    of Q4_STAGES stages, each x (Q4_MP x Q4_BK bf16, swizzled), packed W
    (Q4_BK / 2 rows of Q4_BN + 32 bytes) and a row of Q4_BN f32 scales
    rounded up to 1 KB, which the f32 partial tile (Q4_MP x (Q4_BN + 4))
    reuses at the end, and 1 KB for the ring's 1024-byte alignment."""
    stage = Q4_MP * Q4_BK * 2 + (Q4_BK // 2) * (Q4_BN + 32) + Q4_BN * 4
    stage = -(-stage // 1024) * 1024
    return max(Q4_STAGES * stage, Q4_MP * (Q4_BN + 4) * 4) + 1024


def q4_plan(M: int, K: int, N: int, sms: int, resident: Tuple[int, ...]) -> SplitPlan:
    """Row 7's launch: `split_plan` over the Q4_BK-row groups of K."""
    return split_plan(M, K // Q4_BK, N, sms, resident)


def q4_resident(device: torch.device) -> Tuple[int, ...]:
    """How many clusters of each of WONLY_SPLITS row 7 fits on `device` at once."""
    return _resident("int4_matmul", "q4_matmul_max_clusters", device)


def int4_matmul(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor,
                group: int = Q4_GROUP) -> torch.Tensor:
    """x: [..., K]; w_packed: [K//2, N] uint8; scale: [K//group, N] f32 ->
    [..., N] in x's type.

    A CPU tensor takes `int4_matmul_plain`; a CUDA tensor launches row 7
    (csrc/int4_matmul.cu), one launch per 256 rows of x (the decode step's
    M is 64; REVISIONLLM_Q4_PALLAS=all sends the prefill's rows too), with
    the split that `q4_plan` picks."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, w_packed, scale, group)
    kernels.forbid_grad("int4_matmul", x, scale)
    K = x.shape[-1]
    N = w_packed.shape[-1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    dev = x.device
    if not (
        M >= 1 and group == Q4_GROUP and K % group == 0 and N % 16 == 0
        and w_packed.shape == (K // 2, N) and scale.shape == (K // group, N)
        and x2.dtype == torch.bfloat16 and w_packed.dtype == torch.uint8
        and scale.dtype == torch.float32 and w_packed.device == dev and scale.device == dev
        and x2.is_contiguous() and w_packed.is_contiguous() and scale.is_contiguous()
        and x2.data_ptr() % 16 == 0 and w_packed.data_ptr() % 16 == 0
        and scale.data_ptr() % 16 == 0
    ):
        raise ValueError(
            "int4_matmul kernel takes contiguous 16-byte-aligned bf16 x [M, K%128==0], uint8 "
            f"w [K/2, N%16==0] and f32 scale [K/128, N], group 128, on one device; got x "
            f"{x2.dtype} {tuple(x2.shape)}, w {w_packed.dtype} {tuple(w_packed.shape)}, scale "
            f"{scale.dtype} {tuple(scale.shape)}, group {group}"
        )
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    fn = kernels.function(
        "int4_matmul", "q4_matmul_bf16",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    )
    for m0 in range(0, M, KERNEL_MAX_M):
        rows = min(KERNEL_MAX_M, M - m0)
        plan = q4_plan(rows, K, N, _sm_count(dev), q4_resident(dev))
        err = fn(
            x2[m0:].data_ptr(), w_packed.data_ptr(), scale.data_ptr(), out[m0:].data_ptr(),
            rows, K, N, plan.splitk, kernels.stream_of(x2),
        )
        kernels.check_launch("int4_matmul", err)
        kernels.LAUNCHES["int4_matmul"] += 1
    return out.reshape(*x.shape[:-1], N)


def _q4_all_kernel() -> bool:
    """REVISIONLLM_Q4_PALLAS=all: every int4 matmul, the prefill's too, takes
    row 7 instead of dequantize-then-matmul (JAX's _q4_all_pallas)."""
    return os.environ.get("REVISIONLLM_Q4_PALLAS", "") == "all"


def q4_apply(x: torch.Tensor, w, group: int = Q4_GROUP) -> torch.Tensor:
    """Matmul for {'q4', 'scale4'} weights, JAX's rule (quant.py:677-692):
    M <= 256 (every decode matmul) or REVISIONLLM_Q4_PALLAS=all -> row 7;
    otherwise (the prefill) the weight dequantized to x's type, then one
    matmul. Under the exact trace always the dequant route."""
    M = x.numel() // x.shape[-1]
    if not _EXACT_TRACE and (M <= KERNEL_MAX_M or _q4_all_kernel()):
        return int4_matmul(x, w["q4"], w["scale4"], group)
    return x @ dequantize_int4(w["q4"], w["scale4"], x.dtype, group)


def quantize_llama_params_int4(params, group: int = Q4_GROUP, quantize_lm_head: bool = True):
    """Int4 variant of quantize_llama_params (the 7B weights in 3.4 GB):
    stacked layer matrices (and the lm_head) become {'q4', 'scale4'} dicts."""
    out = dict(params)
    layers = {}
    for name, w in params["layers"].items():
        if w.ndim < 3 or name.endswith("_norm") or name.endswith("_bias"):
            layers[name] = w
        else:
            q, s = quantize_int4(w, group)
            layers[name] = {"q4": q, "scale4": s}
    out["layers"] = layers
    if quantize_lm_head and not isinstance(params["lm_head"], dict):
        q, s = quantize_int4(params["lm_head"], group)
        out["lm_head"] = {"q4": q, "scale4": s}
    return out


# ---------------------------------------------------------------------------
# Fused W8A8 MLP tail (REVISIONLLM_FUSED_MLP): kernel row 8
# ---------------------------------------------------------------------------


def w8a8_mlp_fused_plain(x_q8, x_scale, g_q8, g_scale, u_q8, u_scale):
    """Row 8's maths (JAX's w8a8_mlp_reference, quant.py:869-881): exact
    int32 gate and up dots, f32 rescale, h = silu(g) * u in f32 as
    g / (1 + exp(-g)) * u, per-row absmax over all N, int8 quantization.
    Returns (h_q8 [M, N] int8, h_scale [M, 1] f32)."""
    g = _int8_dot(x_q8, g_q8).float() * x_scale * g_scale[None, :]
    u = _int8_dot(x_q8, u_q8).float() * x_scale * u_scale[None, :]
    h = (g / (1.0 + torch.exp(-g))) * u
    absmax = h.abs().amax(dim=-1, keepdim=True)
    hs = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    return torch.clamp(torch.round(h / hs), -127, 127).to(torch.int8), hs


def w8a8_mlp_fused(x_q8, x_scale, g_q8, g_scale, u_q8, u_scale):
    """(x_q8 [M, K] int8, x_scale [M, 1] f32) x gate/up ([K, N] int8, [N]
    f32) -> (h_q8 [M, N] int8, h_scale [M, 1] f32), h = silu(x G) * (x U).

    A CPU tensor takes `w8a8_mlp_fused_plain`; a CUDA tensor launches row 8
    (csrc/w8a8_mlp_fused.cu: the weights turned K-major into a scratch, the
    int8 wgmma GEMM with the SwiGLU epilogue into an f32 scratch h, then the
    per-row requantization), and the bf16 [M, N] intermediate never exists.
    The call allocates its two outputs and three scratch tensors: the
    K-major weights [2, N, K] int8, h [M, N] f32 and the row absmax [M]."""
    if x_q8.device.type == "cpu":
        return w8a8_mlp_fused_plain(x_q8, x_scale, g_q8, g_scale, u_q8, u_scale)
    kernels.forbid_grad("w8a8_mlp_fused", x_scale, g_scale, u_scale)
    M, K = x_q8.shape
    N = g_q8.shape[-1]
    dev = x_q8.device
    ints = (x_q8, g_q8, u_q8)
    floats = (x_scale, g_scale, u_scale)
    if not (
        M >= 1 and K % 16 == 0 and N % 16 == 0 and x_scale.shape == (M, 1)
        and g_q8.shape == (K, N) and u_q8.shape == (K, N)
        and g_scale.shape == (N,) and u_scale.shape == (N,)
        and all(t.dtype == torch.int8 and t.device == dev and t.is_contiguous()
                and t.data_ptr() % 16 == 0 for t in ints)
        and all(t.dtype == torch.float32 and t.device == dev and t.is_contiguous()
                for t in floats)
    ):
        raise ValueError(
            "w8a8_mlp_fused kernel takes contiguous 16-byte-aligned int8 x [M, K%16==0], "
            "gate/up [K, N%16==0] and f32 scales [M, 1], [N] on one device; got x "
            f"{x_q8.dtype} {tuple(x_q8.shape)}, gate {g_q8.dtype} {tuple(g_q8.shape)}, "
            f"x_scale {x_scale.dtype} {tuple(x_scale.shape)}"
        )
    wt = torch.empty((2, N, K), dtype=torch.int8, device=dev)
    h = torch.empty((M, N), dtype=torch.float32, device=dev)
    rowmax = torch.empty((M,), dtype=torch.float32, device=dev)
    hq = torch.empty((M, N), dtype=torch.int8, device=dev)
    hs = torch.empty((M, 1), dtype=torch.float32, device=dev)
    fn = kernels.function("w8a8_mlp_fused", "w8a8_mlp_fused",
                          [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    err = fn(x_q8.data_ptr(), x_scale.data_ptr(), g_q8.data_ptr(), g_scale.data_ptr(),
             u_q8.data_ptr(), u_scale.data_ptr(), wt.data_ptr(), h.data_ptr(),
             rowmax.data_ptr(), hq.data_ptr(), hs.data_ptr(), M, K, N, kernels.stream_of(x_q8))
    kernels.check_launch("w8a8_mlp_fused", err)
    kernels.LAUNCHES["w8a8_mlp_fused"] += 1
    return hq, hs


def w8a8_prequant_matmul(x_q8: torch.Tensor, x_scale: torch.Tensor, w_q8: torch.Tensor,
                         w_scale: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """int8 x int8 for an activation that is already quantized (row 8's
    output): exact int32 product, (acc * x_scale * w_scale) in f32, cast to
    out_dtype. An int8 dot outside any Pallas kernel in JAX (:856-866), so
    here `w8a8_gemm` as for W8A8."""
    return w8a8_gemm(x_q8, x_scale, w_q8, w_scale, out_dtype=out_dtype)
