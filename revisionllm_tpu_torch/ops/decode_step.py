"""The whole-step decode megakernel (REVISIONLLM_MEGAKERNEL): kernel row 9
(csrc/decode_step.cu) and its plain version.

Counterpart of revisionllm_tpu/ops/decode_step.py. One launch runs the whole
L-layer decode step of the Vicuna-7B serving configuration -- RMSNorm, int8
q/k/v/o/gate/up/down with per-column scales, rope, attention over [int8
prompt | bf16 gen slots < step | self], SwiGLU, residuals -- in place of
decode_step_split's ~225 launches and their glue. models/generation.py then
runs the final norm and the lm_head (K1).

Scope, as in JAX: MHA (H == KH), full-head non-interleaved rope, no qkv
bias, int8 weights, an int8 prompt cache with per-(position, head) scales, a
gen cache in the activations' type. Layouts and signatures are JAX's: the
packed prompt cache {"kv": [L, B, 2, KH, Sp, hd] int8, "kvsc": [L, B, 2,
KH, Sp] f32} and the gen cache [L, 2, B, KH, Gp, hd]. The port pads S only
as far as its own loads need, which is not at all (Sp = S; JAX pads to 128
rows for the TPU's DMA); Gp is G rounded up to 8, as in JAX. The kernel
masks every position at or past a row's prompt length and every gen slot
at or past `step`, so padding never enters a result. The gen cache is
written in place (JAX returns an updated copy).
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Tuple

import torch

from revisionllm_tpu_torch.utils import kernels

NEG_INF = -2.0e30
MATRICES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
# csrc/decode_common.cuh's geometry, mirrored to size the scratch and to
# check the shared memory before a launch:
ROWS_PER_LAUNCH = 64    # MP: a larger batch takes one launch per 64 rows
KSLICE, BK = 1024, 128  # the K slicing, in whole weight boxes of BK rows
CONSUMER_WARPGROUPS, STAGES = 3, 2  # CWG, and the ring stages of each
ATTN_WARPS = 4 * CONSUMER_WARPGROUPS  # AWARPS: the attention phase's warps, in teams
ATTN_STAGES, ATTN_TILE = 4, 12288     # ASTAGES, ATILE: a team ring's most slots, a slot's bytes
HD = 128                # the head dim
ATTN_SCALES = ATTN_TILE // HD + 4     # ASCL: a slot's scale floats (a tile's, aligned to 16 bytes)
# SMEM_FIXED: the alignment slack, the rings of 128 x 128 int8 boxes, the barriers
SMEM_FIXED = 1024 + CONSUMER_WARPGROUPS * STAGES * BK * 128 + 1024
SMEM_MAX = 227 * 1024   # the H100's shared memory a block


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pack_prompt_kv(prompt_kv: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Quantized split cache {"k", "k_scale", "v", "v_scale"} [L, B, S, KH,
    hd] -> {"kv": [L, B, 2, KH, S, hd] int8 (head-major, k and v side by
    side), "kvsc": [L, B, 2, KH, S] f32}: one transposing copy per tensor
    into a preallocated pack."""
    k = prompt_kv["k"]
    L, B, S, KH, hd = k.shape
    kv = torch.empty((L, B, 2, KH, S, hd), dtype=k.dtype, device=k.device)
    kvsc = torch.empty((L, B, 2, KH, S), dtype=torch.float32, device=k.device)
    for i, name in enumerate(("k", "v")):
        kv[:, :, i].copy_(prompt_kv[name].permute(0, 1, 3, 2, 4))
        kvsc[:, :, i].copy_(prompt_kv[f"{name}_scale"].permute(0, 1, 3, 2))
    return {"kv": kv, "kvsc": kvsc}


def init_gen_cache(L: int, B: int, KH: int, hd: int, G: int, dtype, device=None) -> torch.Tensor:
    """Megakernel gen cache: one zeroed tensor [L, 2 (k, v), B, KH, Gp, hd],
    Gp = G rounded up to 8."""
    return torch.zeros((L, 2, B, KH, _round_up(G, 8), hd), dtype=dtype, device=device)


def supports_megakernel(cfg, params) -> bool:
    """The serving shapes the kernel covers (others take decode_step_split)."""
    if cfg.num_heads != cfg.num_kv_heads or cfg.qkv_bias:
        return False
    if cfg.rope_interleaved or cfg.rope_fraction < 1.0:
        return False
    lq = params["layers"].get("q_proj")
    return isinstance(lq, dict) and "q8" in lq


def _rms_norm_bf16(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel's RMSNorm: (x * rsqrt(mean(x^2) + eps)) * gamma in f32,
    rounded to bf16 (the input of every weight dot)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * gamma.float()).to(torch.bfloat16)


def decode_step_fused_plain(
    params: Dict[str, Any],
    pkv: Dict[str, torch.Tensor],
    genkv: torch.Tensor,
    prompt_lens: torch.Tensor,
    step: int,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row 9's arithmetic step by step (revisionllm_tpu/ops/decode_step.py:
    198-480): h rounds to bf16 before each weight dot; int8 weights are exact
    in bf16, products accumulate in f32, then times the column scale; q, k, v
    stay f32; rope in f32; prompt scores bf16 q . int8 K * k_scale * hd^-0.5,
    gen scores bf16 q . bf16 cache, the self term f32 q . k_new; one shared
    max; p1 * v_scale and p2 rounded to bf16 before their value dots; the self
    value term f32; the divide by the unrounded denominator; the residual
    rounded to x's type after each add; m = bf16(silu(g)), then bf16(m * u).
    Writes this step's k/v into gen slot `step` and returns (hidden [B, D]
    in x's type, genkv)."""
    layers = params["layers"]
    L = layers["q_proj"]["q8"].shape[0]
    B, D = x.shape
    kv, kvsc = pkv["kv"], pkv["kvsc"]
    H, Sp, hd = kv.shape[3], kv.shape[4], kv.shape[5]
    Gp = genkv.shape[4]
    scale = hd ** -0.5
    dev = x.device
    cos_full = torch.cat([cos, cos], dim=-1).float().repeat(1, H)   # [B, H * hd]
    sin_full = torch.cat([sin, sin], dim=-1).float().repeat(1, H)
    s_live = torch.arange(Sp, device=dev)[None, None, :] < prompt_lens.to(dev)[:, None, None]
    g_live = torch.arange(Gp, device=dev)[None, None, :] < step

    def mm(h_bf, name, l):
        w = layers[name]
        return (h_bf.float() @ w["q8"][l].float()) * w["scale"][l].float()

    def rope(t):
        t3 = t.reshape(B, H, hd)
        rot = torch.cat([-t3[..., hd // 2:], t3[..., : hd // 2]], dim=-1).reshape(B, D)
        return t * cos_full + rot * sin_full

    xres = x.clone()
    for l in range(L):
        h = _rms_norm_bf16(xres, layers["attn_norm"][l], eps)
        q = rope(mm(h, "q_proj", l)).reshape(B, H, hd)
        k = rope(mm(h, "k_proj", l)).reshape(B, H, hd)
        v = mm(h, "v_proj", l).reshape(B, H, hd)
        qb = q.to(torch.bfloat16).float()
        s1 = torch.einsum("bhd,bhsd->bhs", qb, kv[l, :, 0].float()) * kvsc[l, :, 0] * scale
        s1 = torch.where(s_live, s1, torch.full_like(s1, NEG_INF))
        gk = genkv[l, 0].to(torch.bfloat16).float()
        s2 = torch.einsum("bhd,bhgd->bhg", qb, gk) * scale
        s2 = torch.where(g_live, s2, torch.full_like(s2, NEG_INF))
        s_self = (q * k).sum(dim=-1, keepdim=True) * scale
        m = torch.maximum(torch.maximum(s1.amax(-1, keepdim=True), s2.amax(-1, keepdim=True)),
                          s_self)
        p1, p2, ps = torch.exp(s1 - m), torch.exp(s2 - m), torch.exp(s_self - m)
        denom = p1.sum(-1, keepdim=True) + p2.sum(-1, keepdim=True) + ps
        p1v = (p1 * kvsc[l, :, 1]).to(torch.bfloat16).float()
        o1 = torch.einsum("bhs,bhsd->bhd", p1v, kv[l, :, 1].float())
        o2 = torch.einsum("bhg,bhgd->bhd", p2.to(torch.bfloat16).float(),
                          genkv[l, 1].to(torch.bfloat16).float())
        o = (o1 + o2 + ps * v) / denom
        genkv[l, 0, :, :, step] = k.to(genkv.dtype)
        genkv[l, 1, :, :, step] = v.to(genkv.dtype)
        attn = o.reshape(B, D).to(torch.bfloat16)
        xres = (xres.float() + mm(attn, "o_proj", l)).to(x.dtype)
        h = _rms_norm_bf16(xres, layers["mlp_norm"][l], eps)
        g = mm(h, "gate_proj", l)
        mbuf = (g * torch.sigmoid(g)).to(torch.bfloat16)
        mbuf = (mbuf.float() * mm(h, "up_proj", l)).to(torch.bfloat16)
        xres = (xres.float() + mm(mbuf, "down_proj", l)).to(x.dtype)
    return xres, genkv


def _slice_rows(K: int) -> int:
    n = -(-K // KSLICE)
    return _round_up(-(-K // n), BK)


def _slices(K: int) -> int:
    return -(-K // _slice_rows(K))


def attn_scratch_bytes(nsc: int, slices: int, wpt: int) -> int:
    """An attention team's scratch (attn_scratch_bytes) for items of up to
    nsc positions, q/k/v sums over `slices` K slices and wpt warps: the
    staged q/k/v inputs, q rounded to bf16 and q, k, v in f32 for two items,
    two self scores, the scores, the warps' partial outputs, maxima and
    denominators."""
    return 4 * ((3 * slices + 4) * HD + 2 * 4 * HD + 2 + nsc + wpt * (HD + 2))


def attn_team_bytes(stages: int, nsc: int, slices: int, wpt: int) -> int:
    """A team's ring and scratch, rounded up to 128 bytes (attn_team_bytes)."""
    ring = stages * (ATTN_TILE + ATTN_SCALES * 4)
    return -(-(ring + attn_scratch_bytes(nsc, slices, wpt)) // 128) * 128


def attn_layout(nsc: int, slices: int) -> Tuple[int, int]:
    """(teams, ring slots a team) of the attention phase (attn_layout) for
    items of up to nsc positions: the most teams (a divisor of ATTN_WARPS,
    at most CONSUMER_WARPGROUPS) whose rings get at least 2 slots, each up
    to ATTN_STAGES; (0, 0) when not one team fits."""
    room = SMEM_MAX - SMEM_FIXED
    for teams in range(CONSUMER_WARPGROUPS, 0, -1):
        if ATTN_WARPS % teams:
            continue
        for stages in range(ATTN_STAGES, 1, -1):
            if teams * attn_team_bytes(stages, nsc, slices, ATTN_WARPS // teams) <= room:
                return teams, stages
    return 0, 0


def step_smem_bytes(D: int, F: int, nsc: int) -> int:
    """The kernel's dynamic shared memory (step_smem): the fixed regions and
    the larger of the activation slices [64, slice rows] bf16 and the
    attention teams' rings and scratch for items of up to nsc positions."""
    act = max(ROWS_PER_LAUNCH * _slice_rows(K) * 2 for K in (D, F))
    teams, stages = attn_layout(nsc, _slices(D))
    return SMEM_FIXED + max(act, teams * attn_team_bytes(stages, nsc, _slices(D),
                                                         ATTN_WARPS // max(teams, 1)))


def decode_step_fused(
    params: Dict[str, Any],
    pkv: Dict[str, torch.Tensor],
    genkv: torch.Tensor,
    prompt_lens: torch.Tensor,
    step: int,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused decode step from the engine's standard int8 tree.

    x [B, D] (the current token's embedding, before layer 0); cos/sin
    [B, hd/2] f32 at each row's position; prompt_lens [B]. Returns (hidden
    [B, D] -- the final norm and the lm_head run outside -- and genkv, with
    this step's k/v in slot `step`).

    A CPU tensor takes `decode_step_fused_plain`; a CUDA tensor launches
    row 9 once per 64 rows."""
    if x.device.type == "cpu":
        return decode_step_fused_plain(params, pkv, genkv, prompt_lens, step, x, cos, sin, eps)
    layers = params["layers"]
    ws = [layers[n]["q8"] for n in MATRICES]
    scales = [layers[n]["scale"] for n in MATRICES]
    norms = (layers["attn_norm"], layers["mlp_norm"])
    kv, kvsc = pkv["kv"], pkv["kvsc"]
    kernels.forbid_grad("decode_step_fused", x, *scales, *norms)
    B, D = x.shape
    L, _, F = ws[4].shape
    Lk, Bk, two, H, Sp, hd = kv.shape
    Gp = genkv.shape[4]
    dev = x.device
    step = int(step)
    shapes = [(L, D, D)] * 4 + [(L, D, F)] * 2 + [(L, F, D)]
    bf16 = (x, genkv, *norms)
    if not (
        hd == 128 and D == H * hd and F % 16 == 0 and Lk == L and Bk == B and two == 2
        and 0 <= step < Gp and attn_layout(Sp + Gp, _slices(D))[0] >= 1
        and step_smem_bytes(D, F, Sp + Gp) <= SMEM_MAX
        and genkv.shape == (L, 2, B, H, Gp, hd) and kvsc.shape == (L, B, 2, H, Sp)
        and tuple(prompt_lens.shape) == (B,) and cos.shape == (B, hd // 2)
        and sin.shape == (B, hd // 2)
        and all(tuple(w.shape) == s and w.dtype == torch.int8 for w, s in zip(ws, shapes))
        and all(tuple(s.shape) == (L, w.shape[-1]) and s.dtype == torch.float32
                for w, s in zip(ws, scales))
        and all(t.dtype == torch.bfloat16 for t in bf16) and kv.dtype == torch.int8
        and kvsc.dtype == torch.float32
        and all(t.device == dev and t.is_contiguous() and t.data_ptr() % 16 == 0
                for t in (*ws, *scales, *bf16, kv, kvsc)) and kvsc.numel() % 4 == 0
    ):
        raise ValueError(
            "decode_step_fused kernel takes the int8 Vicuna tree (MHA, head dim 128, "
            "F % 16 == 0), a packed int8 prompt cache whose attention ring and "
            "scores fit shared memory beside the weight rings, a bf16 gen cache [L, 2, B, H, Gp, 128] with "
            "0 <= step < Gp, bf16 x [B, D] and f32 cos/sin [B, 64], contiguous and 16-byte "
            "aligned on one device; "
            f"got x {x.dtype} {tuple(x.shape)}, kv {kv.dtype} {tuple(kv.shape)}, genkv "
            f"{genkv.dtype} {tuple(genkv.shape)}, step {step}"
        )
    plen = prompt_lens.to(device=dev, dtype=torch.int32).contiguous()
    cos32, sin32 = cos.float().contiguous(), sin.float().contiguous()
    out = torch.empty_like(x)
    xres = torch.empty((ROWS_PER_LAUNCH, D), dtype=torch.bfloat16, device=dev)
    act = torch.empty((ROWS_PER_LAUNCH, max(D, F)), dtype=torch.bfloat16, device=dev)
    part = torch.empty(
        (max(_slices(D) * 3 * D, _slices(D) * 2 * F, _slices(F) * D) * ROWS_PER_LAUNCH,),
        dtype=torch.float32, device=dev)
    wptrs = (ctypes.c_void_p * 7)(*[w.data_ptr() for w in ws])
    sptrs = (ctypes.c_void_p * 7)(*[s.data_ptr() for s in scales])
    fn = kernels.function(
        "decode_step", "decode_step_fused",
        [ctypes.c_void_p] * 15 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p],
    )
    for b0 in range(0, B, ROWS_PER_LAUNCH):
        nb = min(ROWS_PER_LAUNCH, B - b0)
        err = fn(
            ctypes.cast(wptrs, ctypes.c_void_p), ctypes.cast(sptrs, ctypes.c_void_p),
            norms[0].data_ptr(), norms[1].data_ptr(), kv.data_ptr(), kvsc.data_ptr(),
            genkv.data_ptr(), plen[b0:].data_ptr(), cos32[b0:].data_ptr(),
            sin32[b0:].data_ptr(), x[b0:].data_ptr(), out[b0:].data_ptr(), xres.data_ptr(),
            act.data_ptr(), part.data_ptr(),
            L, nb, B, b0, D, F, H, Sp, Gp, step, float(eps), kernels.stream_of(x),
        )
        kernels.check_launch("decode_step_fused", err)
        kernels.LAUNCHES["decode_step_fused"] += 1
    return out, genkv
