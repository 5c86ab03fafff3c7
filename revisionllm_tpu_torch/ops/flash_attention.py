"""Attention: kernel K2 (csrc/flash_attention.cu) for the prefill, the row-4
kernels for training (the forward with the per-row LSE shares K2's body in
csrc/flash_attention.cu; dq and dk/dv are in csrc/flash_attention_vjp.cu),
their plain versions, the einsum reference and the dispatchers.

Counterpart of revisionllm_tpu/ops/flash_attention.py. The JAX dispatcher
picks the einsum path below 512 tokens and by a 1 GB score rule (:288-344);
those cutovers were measured on a TPU v5e and are not copied: on a CUDA
tensor `attention` always launches K2. On the CPU it runs `mha_reference`,
as JAX does off the TPU.

`trainable_attention` is the differentiable counterpart of JAX's
make_flash_mha (:526): a torch.autograd.Function whose forward stores the
per-row log-sum-exp and whose backward rebuilds P from it. On a CUDA tensor
its three wrappers launch the row-4 kernels; on a CPU tensor they run their
plain versions (the same maths step by step in f32), where JAX runs
mha_reference. The two agree except on rows that see no key, which training
never makes (column 0 is always live).

The shared-prefix prefill attends over a B = 1 prefix and the row's own
causal block. `flash_attention_prefixed` (row 6) does that in one online
softmax on the card; on the CPU it runs two `mha_reference_lse` pieces and
`merge_attention_pieces`, as JAX does off the TPU. `flash_attention_lse`
(row 5, the LSE forward for any S) is what `attention_lse` launches on a
CUDA tensor, and the card's two-piece reference for row 6.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional

import torch

from revisionllm_tpu_torch.utils import kernels

NEG_INF = -2.0e30


def _kv_mask(B, T, S, kv_lens, causal, device) -> torch.Tensor:
    """[B, 1, T, S] bool: column < kv_lens[b] and, when causal, row >= column."""
    col = torch.arange(S, device=device)
    mask = torch.ones((B, 1, T, S), dtype=torch.bool, device=device)
    if kv_lens is not None:
        mask = mask & (col[None, None, None, :] < kv_lens.to(device)[:, None, None, None])
    if causal:
        row = torch.arange(T, device=device)
        mask = mask & (row[:, None] >= col[None, :])[None, None]
    return mask


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    kv_lens: Optional[torch.Tensor] = None, sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """K2's maths step by step, in f32: scores, NEG_INF masking, softmax
    over the live columns, and 0 for a row that sees no key (l_safe)."""
    B, T, H, d = q.shape
    S, KH = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    group = H // KH
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), kf) * sm_scale
    lens = None if kv_lens is None else kv_lens.clamp(max=S)
    mask = _kv_mask(B, T, S, lens, causal, q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhts,bshd->bthd", p / l_safe, vf)
    return o.to(q.dtype)


def _bf16_kernel_inputs(name, q, *rest):
    """Check a forward kernel's inputs: q [B, T, H, 128]; every tensor bf16,
    contiguous and 16-byte aligned on q's device."""
    if q.shape[-1] != 128:
        raise ValueError(f"{name} kernel: head_dim must be 128, got q{tuple(q.shape)}")
    for t in (q,) + rest:
        if not (t.dtype == torch.bfloat16 and t.device == q.device and t.is_contiguous()
                and t.data_ptr() % 16 == 0):
            raise ValueError(f"{name} kernel takes contiguous 16-byte-aligned bf16 tensors "
                             "on one device")


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    kv_lens: Optional[torch.Tensor] = None, sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """q: [B, T, H, d]; k/v: [B, S, KH, d] with H % KH == 0; kv_lens [B]
    masks padded kv columns (default: all S). Returns [B, T, H, d].

    A CPU tensor takes `flash_attention_plain`; a CUDA tensor launches K2
    (bf16, d = 128)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, kv_lens=kv_lens, sm_scale=sm_scale)
    B, T, H, d = q.shape
    S, KH = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if d != 128 or H % KH or k.shape != (B, S, KH, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention kernel: unsupported shapes q{tuple(q.shape)} k{tuple(k.shape)}")
    kernels.forbid_grad("flash_attention", q, k, v)
    _bf16_kernel_inputs("flash_attention", q, k, v)
    lens = _lens_i32(kv_lens, B, S, q.device)
    out = torch.empty_like(q)
    fn = kernels.function(
        "flash_attention", "flash_attn_fwd_bf16",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    )
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
        B, T, S, H, KH, d, float(sm_scale), int(causal), kernels.stream_of(q),
    )
    kernels.check_launch("flash_attention", err)
    kernels.LAUNCHES["flash_attention"] += 1
    return out


_ATTN_BF16: Optional[bool] = None


def set_attn_bf16(enabled: Optional[bool]) -> None:
    """Override the bf16-score switch (None = back to the environment and the
    device default)."""
    global _ATTN_BF16
    _ATTN_BF16 = enabled


def _attn_bf16_scores(device: torch.device) -> bool:
    """REVISIONLLM_ATTN_BF16=1: mha_reference keeps scores and softmax in
    bf16 for bf16 inputs. Default ON for CUDA tensors, OFF on the CPU (exact
    f32 scores), as JAX defaults it ON for the TPU only."""
    if _ATTN_BF16 is not None:
        return _ATTN_BF16
    env = os.environ.get("REVISIONLLM_ATTN_BF16")
    if env is not None:
        return env == "1"
    return device.type == "cuda"


def mha_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    kv_lens: Optional[torch.Tensor] = None, sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain einsum attention, same contract as `flash_attention`, with the
    semantics of revisionllm_tpu's mha_reference (a fully masked row
    averages all columns, as a softmax over equal NEG_INF scores does)."""
    B, T, H, d = q.shape
    S, KH = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if KH != H:
        k = k.repeat_interleave(H // KH, dim=2)
        v = v.repeat_interleave(H // KH, dim=2)
    sdt = torch.bfloat16 if (_attn_bf16_scores(q.device) and q.dtype == torch.bfloat16) else torch.float32
    s = torch.einsum("bthd,bshd->bhts", q.to(sdt), k.to(sdt))
    s = s * torch.tensor(sm_scale, dtype=sdt)
    mask = _kv_mask(B, T, S, kv_lens, causal, q.device)
    s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=sdt, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", p, v.to(sdt))
    return out.to(q.dtype)


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    kv_lens: Optional[torch.Tensor] = None, sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """K2 on a CUDA tensor; `mha_reference` on the CPU."""
    if q.device.type == "cuda":
        return flash_attention(q, k, v, causal=causal, kv_lens=kv_lens, sm_scale=sm_scale)
    return mha_reference(q, k, v, causal=causal, kv_lens=kv_lens, sm_scale=sm_scale)


# ---------------------------------------------------------------------------
# Row 4: differentiable flash attention (forward with LSE, dq, dk/dv)
# ---------------------------------------------------------------------------

LSE_EMPTY = 2.0e30  # lse of a row that sees no key: exp(s - lse) is 0


def _compute_type(q):
    """f32 for the kernels' bf16 and f32 inputs; f64 stays f64 (gradcheck)."""
    return torch.promote_types(q.dtype, torch.float32)


def _vjp_scores(q, k, sm_scale, kv_lens, causal):
    """(scores [B, H, T, S] with kv heads repeated, mask [B, 1, T, S], k
    repeated to H heads), in f32 (f64 for f64 inputs)."""
    ct = _compute_type(q)
    B, T, H, _ = q.shape
    S, KH = k.shape[1], k.shape[2]
    kf = k.to(ct).repeat_interleave(H // KH, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.to(ct), kf) * sm_scale
    lens = None if kv_lens is None else kv_lens.clamp(max=S)
    return s, _kv_mask(B, T, S, lens, causal, q.device), kf


def _vjp_p_ds(q, k, v, do, lse, delta, sm_scale, kv_lens, causal):
    """What both backward kernels rebuild: p = exp(s - lse) on live entries
    (0 elsewhere), dp = dO V^T and ds = p (dp - delta) sm_scale. Returns
    (p, ds) [B, H, T, S] and k repeated to H heads, in f32."""
    s, mask, kf = _vjp_scores(q, k, sm_scale, kv_lens, causal)
    p = torch.where(mask, torch.exp(s - lse.to(s.dtype)[..., None]), torch.zeros_like(s))
    vf = v.to(s.dtype).repeat_interleave(q.shape[2] // v.shape[2], dim=2)
    dp = torch.einsum("bthd,bshd->bhts", do.to(s.dtype), vf)
    return p, p * (dp - delta[..., None]) * sm_scale, kf


def flash_fwd_lse_plain(q, k, v, *, causal=True, kv_lens=None, sm_scale=None):
    """The forward kernel's maths in f32: masked scores, softmax over the
    live columns with P rounded to v's type before P V, and the per-row
    lse = m + log(l) [B, H, T] f32 (LSE_EMPTY where l == 0, whose output
    row is 0). Returns (o [B, T, H, d] in q's type, lse). f64 inputs keep
    f64 throughout, for gradcheck."""
    ct = _compute_type(q)
    B, T, H, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    s, mask, _ = _vjp_scores(q, k, sm_scale, kv_lens, causal)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    lse = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, torch.ones_like(l))),
                      torch.full_like(l, LSE_EMPTY))[..., 0]
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    vf = v.to(ct).repeat_interleave(H // v.shape[2], dim=2)
    o = torch.einsum("bhts,bshd->bhtd", p.to(v.dtype).to(ct), vf) / l_safe
    return o.transpose(1, 2).to(q.dtype), lse


def flash_dq_plain(q, k, v, do, lse, delta, *, causal=True, kv_lens=None, sm_scale=None):
    """The dq kernel's maths in f32: p = exp(s - lse) under the mask,
    dp = dO V^T, ds = p (dp - delta) sm_scale, dq = ds K with ds rounded to
    k's type first. lse, delta [B, H, T] f32. Returns dq in q's type."""
    ct = _compute_type(q)
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    _, ds, kf = _vjp_p_ds(q, k, v, do, lse, delta, sm_scale, kv_lens, causal)
    dq = torch.einsum("bhts,bshd->bthd", ds.to(k.dtype).to(ct), kf)
    return dq.to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, *, causal=True, kv_lens=None, sm_scale=None):
    """The dk/dv kernel's maths in f32: dv = P^T dO and dk = dS^T Q per query
    head (P and dS rounded to the input type first), summed over the query
    heads of each kv head in f32. Returns (dk, dv) in k's and v's types."""
    ct = _compute_type(q)
    B, T, H, d = q.shape
    KH = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    p, ds, _ = _vjp_p_ds(q, k, v, do, lse, delta, sm_scale, kv_lens, causal)
    dv = torch.einsum("bhts,bthd->bshd", p.to(q.dtype).to(ct), do.to(ct))
    dk = torch.einsum("bhts,bthd->bshd", ds.to(q.dtype).to(ct), q.to(ct))
    S = k.shape[1]
    dk = dk.reshape(B, S, KH, H // KH, d).sum(dim=3)
    dv = dv.reshape(B, S, KH, H // KH, d).sum(dim=3)
    return dk.to(k.dtype), dv.to(v.dtype)


def _vjp_args(name, q, k, *rest):
    """Check the row-4 kernels' inputs: q [B, T, H, 128], k-shaped and
    q-shaped bf16 tensors, contiguous and 16-byte aligned on one device."""
    B, T, H, d = q.shape
    KH = k.shape[2]
    if d != 128 or H % KH or k.shape != (B, T, KH, d):
        raise ValueError(f"{name} kernel: unsupported shapes q{tuple(q.shape)} k{tuple(k.shape)}")
    _bf16_kernel_inputs(name, q, k, *rest)
    return B, T, H, KH, d


def _lens_i32(kv_lens, B, T, device):
    if kv_lens is None:
        return torch.full((B,), T, dtype=torch.int32, device=device)
    return kv_lens.to(device=device, dtype=torch.int32).clamp(max=T).contiguous()


def _stats_f32(name, *stats):
    for t in stats:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous f32 lse and delta [B, H, T]")


def _launch_fwd_lse(name, q, k, v, lens, causal, sm_scale):
    """Launch the LSE forward (rows 4 and 5: K2's body with the LSE output)
    on checked bf16 q [B, T, H, d] and k/v [B, S, KH, d] with int32 lens
    [B] (each <= S); counts the launch under `name`. Returns (o, lse
    [B, H, T] f32)."""
    B, T, H, d = q.shape
    S, KH = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    fn = kernels.function(
        "flash_attention", "flash_fwd_lse_bf16",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    )
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
             lse.data_ptr(), B, T, S, H, KH, d, float(sm_scale), int(causal), kernels.stream_of(q))
    kernels.check_launch(name, err)
    kernels.LAUNCHES[name] += 1
    return out, lse


def flash_fwd_lse(q, k, v, *, causal=True, kv_lens=None, sm_scale=None):
    """q [B, T, H, d], k/v [B, T, KH, d] -> (o [B, T, H, d], lse [B, H, T]
    f32). A CPU tensor takes `flash_fwd_lse_plain`; a CUDA tensor launches
    the forward kernel of row 4, K2's body with the LSE output (bf16,
    d = 128)."""
    if q.device.type == "cpu":
        return flash_fwd_lse_plain(q, k, v, causal=causal, kv_lens=kv_lens, sm_scale=sm_scale)
    kernels.forbid_grad("flash_fwd_lse", q, k, v)
    B, T, H, KH, d = _vjp_args("flash_fwd_lse", q, k, v)
    if v.shape != k.shape:
        raise ValueError("flash_fwd_lse kernel: v must have k's shape")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    return _launch_fwd_lse("flash_fwd_lse", q, k, v, _lens_i32(kv_lens, B, T, q.device),
                           causal, sm_scale)


def flash_dq(q, k, v, do, lse, delta, *, causal=True, kv_lens=None, sm_scale=None):
    """dq [B, T, H, d] from the forward's inputs, dO, lse and delta
    (rowsum(dO * O), [B, H, T] f32). A CPU tensor takes `flash_dq_plain`; a
    CUDA tensor launches the dq kernel of row 4."""
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, causal=causal, kv_lens=kv_lens,
                              sm_scale=sm_scale)
    kernels.forbid_grad("flash_dq", q, k, v, do, lse, delta)
    B, T, H, KH, d = _vjp_args("flash_dq", q, k, v, do)
    _stats_f32("flash_dq", lse, delta)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    lens = _lens_i32(kv_lens, B, T, q.device)
    dq = torch.empty_like(q)
    fn = kernels.function(
        "flash_attention_vjp", "flash_dq_bf16",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    )
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), lens.data_ptr(), dq.data_ptr(), B, T, H, KH, d,
             float(sm_scale), int(causal), kernels.stream_of(q))
    kernels.check_launch("flash_dq", err)
    kernels.LAUNCHES["flash_dq"] += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, *, causal=True, kv_lens=None, sm_scale=None):
    """(dk, dv) [B, T, KH, d], as `flash_dq`. A CPU tensor takes
    `flash_dkv_plain`; a CUDA tensor launches the dk/dv kernel of row 4."""
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, causal=causal, kv_lens=kv_lens,
                               sm_scale=sm_scale)
    kernels.forbid_grad("flash_dkv", q, k, v, do, lse, delta)
    B, T, H, KH, d = _vjp_args("flash_dkv", q, k, v, do)
    _stats_f32("flash_dkv", lse, delta)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    lens = _lens_i32(kv_lens, B, T, q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = kernels.function(
        "flash_attention_vjp", "flash_dkv_bf16",
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    )
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), lens.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, T, H, KH, d,
             float(sm_scale), int(causal), kernels.stream_of(q))
    kernels.check_launch("flash_dkv", err)
    kernels.LAUNCHES["flash_dkv"] += 1
    return dk, dv


class FlashMHA(torch.autograd.Function):
    """o = attention(q, k, v) with the row-4 VJP: forward saves (o, lse),
    backward computes delta = rowsum(dO * O) in f32 (outside the kernels,
    as JAX does) and launches dq and dk/dv."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, causal, sm_scale):
        o, lse = flash_fwd_lse(q, k, v, causal=causal, kv_lens=kv_lens, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, o, lse, kv_lens)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_lens = ctx.saved_tensors
        do = do.contiguous()
        ct = _compute_type(o)
        delta = (do.to(ct) * o.to(ct)).sum(dim=-1).transpose(1, 2).contiguous()
        kw = dict(causal=ctx.causal, kv_lens=kv_lens, sm_scale=ctx.sm_scale)
        dq = flash_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None, None


def trainable_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    kv_lens: Optional[torch.Tensor] = None, sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Differentiable attention for training shapes (T == S): q [B, T, H, d],
    k/v [B, T, KH, d] -> [B, T, H, d] through FlashMHA, the row-4 kernels on
    a CUDA tensor and their plain versions on a CPU one."""
    if k.shape[1] != q.shape[1]:
        raise ValueError("trainable_attention requires T == S")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return FlashMHA.apply(q, k, v, kv_lens, causal, float(sm_scale))


# ---------------------------------------------------------------------------
# Rows 5 and 6: the LSE forward for any S, and the shared-prefix attention
# ---------------------------------------------------------------------------


def mha_reference_lse(q, k, v, *, causal=True, kv_lens=None, sm_scale=None):
    """JAX's mha_reference_lse (:798), in f32: (o [B, T, H, d] in q's type,
    lse [B, T, H] f32). Its l is never 0, so a row that sees no key averages
    every column and gets lse = NEG_INF + log(S), about NEG_INF (JAX's
    -NEG_INF branch is never taken): in a merge that piece weighs 0."""
    B, T, H, d = q.shape
    S, KH = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    kf = k.float().repeat_interleave(H // KH, dim=2)
    vf = v.float().repeat_interleave(H // KH, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), kf) * sm_scale
    mask = _kv_mask(B, T, S, kv_lens, causal, q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhts,bshd->bthd", p / torch.where(l == 0, torch.ones_like(l), l), vf)
    l, m = l[..., 0], m[..., 0]
    lse = torch.where(l > 0, m + torch.log(torch.where(l == 0, torch.ones_like(l), l)),
                      torch.full_like(l, -NEG_INF))
    return o.to(q.dtype), lse.transpose(1, 2)


def merge_attention_pieces(o1, lse1, o2, lse2):
    """Combine two attention outputs [B, T, H, d] over disjoint kv sets by
    their lse [B, T, H]: weights softmax(lse1, lse2), in f32, returned in
    o1's type (JAX :844)."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    denom = w1 + w2
    return (o1.float() * (w1 / denom)[..., None]
            + o2.float() * (w2 / denom)[..., None]).to(o1.dtype)


def flash_attention_lse_plain(q, k, v, *, causal=True, kv_lens=None, sm_scale=None):
    """Row 5's maths (`flash_fwd_lse_plain`, for any S): (o [B, T, H, d],
    lse [B, T, H] f32), lse = LSE_EMPTY and o = 0 for a row that sees no
    key."""
    o, lse = flash_fwd_lse_plain(q, k, v, causal=causal, kv_lens=kv_lens, sm_scale=sm_scale)
    return o, lse.transpose(1, 2)


def flash_attention_lse(q, k, v, *, causal=True, kv_lens=None, sm_scale=None):
    """q [B, T, H, d], k/v [B, S, KH, d] (S != T allowed) -> (o [B, T, H,
    d], lse [B, T, H] f32), JAX's flash_attention_lse (:721). A CPU tensor
    takes `flash_attention_lse_plain`; a CUDA tensor launches row 5, the
    LSE forward of csrc/flash_attention.cu (bf16, d = 128); its [B, H, T]
    lse is returned transposed."""
    if q.device.type == "cpu":
        return flash_attention_lse_plain(q, k, v, causal=causal, kv_lens=kv_lens,
                                         sm_scale=sm_scale)
    kernels.forbid_grad("flash_attention_lse", q, k, v)
    _bf16_kernel_inputs("flash_attention_lse", q, k, v)
    B, T, H, d = q.shape
    S, KH = k.shape[1], k.shape[2]
    if H % KH or k.shape != (B, S, KH, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention_lse kernel: unsupported shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    o, lse = _launch_fwd_lse("flash_attention_lse", q, k, v, _lens_i32(kv_lens, B, S, q.device),
                             causal, sm_scale)
    return o, lse.transpose(1, 2)


def attention_lse(q, k, v, *, causal=True, kv_lens=None, sm_scale=None):
    """Row 5 on a CUDA tensor; `mha_reference_lse` on the CPU (JAX :834)."""
    if q.device.type == "cuda":
        return flash_attention_lse(q, k, v, causal=causal, kv_lens=kv_lens, sm_scale=sm_scale)
    return mha_reference_lse(q, k, v, causal=causal, kv_lens=kv_lens, sm_scale=sm_scale)


def flash_attention_prefixed_plain(q, k, v, prefix_k, prefix_v, *, kv_lens=None, sm_scale=None):
    """Row 6's plain version, the twin of JAX's prefixed_attention_reference
    (:1035): attention over the broadcast prefix (not causal) and over the
    row's own k/v (causal, kv_lens), each by `mha_reference_lse` in f32,
    merged by their lse."""
    B = q.shape[0]
    pk = prefix_k.expand((B,) + tuple(prefix_k.shape[1:]))
    pv = prefix_v.expand((B,) + tuple(prefix_v.shape[1:]))
    o1, lse1 = mha_reference_lse(q, pk, pv, causal=False, sm_scale=sm_scale)
    o2, lse2 = mha_reference_lse(q, k, v, causal=True, kv_lens=kv_lens, sm_scale=sm_scale)
    return merge_attention_pieces(o1, lse1, o2, lse2)


def flash_attention_prefixed(q, k, v, prefix_k, prefix_v, *, kv_lens=None, sm_scale=None):
    """q [B, T, H, d], k/v [B, T, KH, d] in local positions (causal, kv_lens
    [B] live rows each), prefix_k/v [1, P, KH, d] visible to every row ->
    o [B, T, H, d] (JAX's flash_attention_prefixed, :945). A CPU tensor takes
    `flash_attention_prefixed_plain`; a CUDA tensor launches row 6, one
    online softmax over the prefix tiles and then the causal tiles (bf16,
    d = 128)."""
    if q.device.type == "cpu":
        return flash_attention_prefixed_plain(q, k, v, prefix_k, prefix_v, kv_lens=kv_lens,
                                              sm_scale=sm_scale)
    kernels.forbid_grad("flash_attention_prefixed", q, k, v, prefix_k, prefix_v)
    _bf16_kernel_inputs("flash_attention_prefixed", q, k, v, prefix_k, prefix_v)
    B, T, H, d = q.shape
    KH, P = k.shape[2], prefix_k.shape[1]
    if (H % KH or k.shape != (B, T, KH, d) or v.shape != k.shape or P < 1
            or prefix_k.shape != (1, P, KH, d) or prefix_v.shape != prefix_k.shape):
        raise ValueError(f"flash_attention_prefixed kernel: unsupported shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} prefix_k{tuple(prefix_k.shape)}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    lens = _lens_i32(kv_lens, B, T, q.device).clamp(min=0)
    out = torch.empty_like(q)
    fn = kernels.function(
        "flash_attention", "flash_prefix_fwd_bf16",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p],
    )
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), prefix_k.data_ptr(), prefix_v.data_ptr(),
             lens.data_ptr(), out.data_ptr(), B, T, P, H, KH, d, float(sm_scale),
             kernels.stream_of(q))
    kernels.check_launch("flash_attention_prefixed", err)
    kernels.LAUNCHES["flash_attention_prefixed"] += 1
    return out
