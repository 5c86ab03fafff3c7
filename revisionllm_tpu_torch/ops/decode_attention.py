"""Single-token decode attention over [prompt | generated]: kernel K3
(csrc/decode_attention.cu) and its plain version.

Counterpart of revisionllm_tpu/ops/decode_attention.py (a study kernel off
the JAX serving path), generalised to what the serving path computes in
revisionllm_tpu/models/llama.py:686-749: an int8 prompt cache with
per-(position, head) scales, a bf16 gen cache, GQA, one shared max over the
two pieces. The layout is the cache's own, one layer at a time: prompt
[B, S, KH, hd] (+ scales [B, S, KH]), gen [B, G, KH, hd]; nothing is
transposed per step.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from revisionllm_tpu_torch.utils import kernels

NEG_INF = -2.0e30
# csrc/decode_attention.cu's geometry, mirrored to check a launch's shared
# memory: attention warps a block, ring slots, tile bytes; the heads of a
# scale box (floats a position of a slot's scales)
KWARPS, KSTAGES, KTILE, SST = 4, 3, 8192, 4
SMEM_MAX = 227 * 1024
# the query heads a kv head that K3 is built for (16: ChatGLM2's 32 over 2)
K3_GROUPS = (1, 2, 4, 8, 16)
# group 16's kernel (decode_attn_kernel_g16), mirrored: warps a block,
# positions a warp's slice, position rounds in flight, ranks (blocks of a
# thread-block cluster) an item's walk is split over at most, bytes a staged
# K or V row
KG16_WARPS, KG16_SLICE, KG16_STAGES, KG16_CLUSTER, KG16_ROW = 4, 16, 2, 8, 272
KG16_ROUND = KG16_WARPS * KG16_SLICE  # positions a round


def g16_split(S: int, step: int) -> int:
    """The ranks group 16's kernel splits each (row, kv head) item over: one
    round of KG16_ROUND positions a rank while S + step + 1 allows, at most
    KG16_CLUSTER (g16_split in csrc/decode_attention.cu)."""
    return min(KG16_CLUSTER, -(-(S + step + 1) // KG16_ROUND))


def smem_bytes(S: int, G: int, group: int, hd: int = 128) -> int:
    """K3's dynamic shared memory at groups 1-8 (k3_smem; group 16's is a
    constant, KG16_SMEM): the ring's tiles, scales and
    barriers, q for two items, the scores [group, S + G], the warps' partial
    outputs, maxima and denominators, and the alignment slack."""
    return (128 + KSTAGES * (KTILE + KTILE // hd * SST * 4 + 16) + 4 * 2 * group * hd
            + 4 * group * (S + G) + 4 * KWARPS * group * (hd + 2))


def decode_attention_plain(
    q: torch.Tensor,
    prompt_k: torch.Tensor,
    prompt_v: torch.Tensor,
    k_scale: Optional[torch.Tensor],
    v_scale: Optional[torch.Tensor],
    gen_k: torch.Tensor,
    gen_v: torch.Tensor,
    mask_lens: torch.Tensor,
    step: int,
) -> torch.Tensor:
    """K3's maths step by step (the einsums of llama.py:686-749).

    q [B, KH, group, hd] (rope applied); prompt_k/v [B, S, KH, hd] int8 with
    k_scale/v_scale [B, S, KH], or in q's type with scales None; gen_k/v
    [B, G, KH, hd] holding this step's k/v at slot `step`; mask_lens [B].
    Returns [B, KH, group, hd] in q's type."""
    S, G = prompt_k.shape[1], gen_k.shape[1]
    hd = q.shape[-1]
    scale = hd ** -0.5
    qf = q.float()
    s1 = torch.einsum("bkgd,bskd->bkgs", qf, prompt_k.to(q.dtype).float()) * scale
    if k_scale is not None:
        s1 = s1 * k_scale.permute(0, 2, 1)[:, :, None, :]
    prompt_mask = torch.arange(S, device=q.device)[None, :] < mask_lens.to(q.device)[:, None]
    s1 = torch.where(prompt_mask[:, None, None, :], s1, torch.full_like(s1, NEG_INF))
    s2 = torch.einsum("bkgd,bskd->bkgs", qf, gen_k.to(q.dtype).float()) * scale
    gen_mask = torch.arange(G, device=q.device) <= step
    s2 = torch.where(gen_mask[None, None, None, :], s2, torch.full_like(s2, NEG_INF))

    m = torch.maximum(s1.amax(dim=-1, keepdim=True), s2.amax(dim=-1, keepdim=True))
    p1 = torch.exp(s1 - m)
    p2 = torch.exp(s2 - m)
    denom = p1.sum(dim=-1, keepdim=True) + p2.sum(dim=-1, keepdim=True)
    p1v = p1 * v_scale.permute(0, 2, 1)[:, :, None, :] if v_scale is not None else p1
    o1 = torch.einsum("bkgs,bskd->bkgd", p1v.to(q.dtype).float(), prompt_v.to(q.dtype).float())
    o2 = torch.einsum("bkgs,bskd->bkgd", p2.to(q.dtype).float(), gen_v.to(q.dtype).float())
    return ((o1 + o2) / denom).to(q.dtype)


def decode_attention(
    q: torch.Tensor,
    prompt_k: torch.Tensor,
    prompt_v: torch.Tensor,
    k_scale: Optional[torch.Tensor],
    v_scale: Optional[torch.Tensor],
    gen_k: torch.Tensor,
    gen_v: torch.Tensor,
    mask_lens: torch.Tensor,
    step: int,
) -> torch.Tensor:
    """Same contract as `decode_attention_plain`. A CPU tensor takes the plain
    version; a CUDA tensor launches K3 (bf16 q and gen cache, int8 or bf16
    prompt cache, hd = 128, group in K3_GROUPS) and raises for any other
    shape."""
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, prompt_k, prompt_v, k_scale, v_scale, gen_k, gen_v, mask_lens, step
        )
    B, KH, group, hd = q.shape
    S, G = prompt_k.shape[1], gen_k.shape[1]
    if hd != 128 or group not in K3_GROUPS:
        raise ValueError(f"decode_attention kernel: unsupported q shape {tuple(q.shape)}")
    if not 0 <= step < G:
        raise ValueError(f"decode_attention: step {step} outside the {G} gen slots")
    dev = q.device
    quantized = prompt_k.dtype == torch.int8
    pdt = torch.int8 if quantized else torch.bfloat16
    caches = (prompt_k, prompt_v, gen_k, gen_v) + ((k_scale, v_scale) if quantized else ())
    if not (
        q.dtype == torch.bfloat16 and prompt_k.dtype == pdt and prompt_v.dtype == pdt
        and gen_k.dtype == torch.bfloat16 and gen_v.dtype == torch.bfloat16
        and prompt_k.shape == (B, S, KH, hd) and prompt_v.shape == (B, S, KH, hd)
        and gen_k.shape == (B, G, KH, hd) and gen_v.shape == (B, G, KH, hd)
        and (k_scale is None) == (not quantized) and (v_scale is None) == (not quantized)
        and (not quantized or (k_scale.shape == (B, S, KH) and v_scale.shape == (B, S, KH)
                               and k_scale.dtype == torch.float32 and v_scale.dtype == torch.float32))
        and all(t.device == dev and t.is_contiguous() for t in (q,) + caches)
        # 16-byte rows and copies; group 16 reads each scale alone (4 bytes)
        and all(t.data_ptr() % (4 if group == 16 and t.dtype == torch.float32 else 16) == 0
                for t in (q,) + caches)
    ):
        raise ValueError(
            "decode_attention kernel takes contiguous 16-byte-aligned bf16 q [B, KH, group, hd], "
            "prompt k/v [B, S, KH, hd] int8 with f32 scales [B, S, KH] (or bf16 without), "
            "bf16 gen k/v [B, G, KH, hd] on one device"
        )
    if group != 16 and smem_bytes(S, G, group, hd) > SMEM_MAX:
        raise ValueError(f"decode_attention kernel: S={S} needs {smem_bytes(S, G, group, hd)} B "
                         "of shared memory")
    if quantized and KH % SST and group != 16:
        # groups 1-8 read the scales of SST heads a position (a TMA row is a
        # multiple of 16 bytes): pad KH to a multiple of 4 heads (group 16
        # reads each scale in place)
        pad = (0, -KH % SST)
        k_scale, v_scale = (torch.nn.functional.pad(t, pad).contiguous() for t in (k_scale, v_scale))
    lens = mask_lens.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    fn = kernels.function(
        "decode_attention", "decode_attn_bf16",
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p],
    )
    err = fn(
        q.data_ptr(), prompt_k.data_ptr(), prompt_v.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        gen_k.data_ptr(), gen_v.data_ptr(), lens.data_ptr(), out.data_ptr(),
        B, S, G, KH, group, hd, int(quantized), int(step), float(hd ** -0.5),
        kernels.stream_of(q),
    )
    kernels.check_launch("decode_attention", err)
    kernels.LAUNCHES["decode_attention"] += 1
    return out
