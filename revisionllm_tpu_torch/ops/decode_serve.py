"""The serving weight layout and its whole-step decode (REVISIONLLM_SERVE):
kernel row 10 (csrc/decode_serve.cu) and its plain version.

Counterpart of revisionllm_tpu/ops/decode_serve.py. Two layouts replace the
standard ones on the serving path:

- packed weights (`pack_serving_weights`): q/k/v/o/gate/up as column chunks
  {"q8c": [L, nc, D, block_n] int8, "scale": [L, Np] f32}, N zero-padded to
  Np = nc * block_n with zero scale, and down_proj as row chunks {"q8r":
  [L, ncf, block_f, D], "scale": [L, D]}, F zero-padded to the same Fp (the
  lcm of the two block sizes divides it). The prefill and the split decode
  step take them through ops.quant.q8c_apply;
- one unified int8 KV slab per prefill {"kv": [L, B, 2, KH, Sp, hd] int8,
  "kvsc": [L, B, 2, KH, Sp] f32}, Sp = round_up(S + G, 128) as in JAX (so
  the slabs compare element for element), which holds a row's prompt at [0,
  plen) and its generated tokens, quantized, at [S0, S0 + step) with S0 = S.

`decode_step_serve` runs one decode step of every layer over them in one
launch on the card, then quantizes the step's new k/v into the slab
(`land_new_kv`). The slab is updated IN PLACE (JAX returns updated copies,
which would double a 6.4 GB slab at Vicuna-7B's chunk of 64).

Scope, as in JAX: MHA (H == KH), full-head non-interleaved rope, no qkv
bias, int8 weights, D a multiple of block_n (`supports_serve`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Any, Dict, Tuple

import torch

from revisionllm_tpu_torch.ops.decode_step import (
    NEG_INF,
    ROWS_PER_LAUNCH,
    SMEM_MAX,
    _rms_norm_bf16,
    _round_up,
    _slices,
    attn_layout,
    step_smem_bytes,
)
from revisionllm_tpu_torch.utils import kernels

COL_MATS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj")


def pack_serving_weights(layers: Dict[str, Any], block_n: int = 1024,
                         block_f: int = 1024) -> Dict[str, Any]:
    """Standard stacked int8 layer tree -> the serving chunks (norms pass
    through), on the tree's device, one matrix at a time."""
    f_pad = math.lcm(block_n, block_f)
    out: Dict[str, Any] = {}
    for name in COL_MATS:
        w, s = layers[name]["q8"], layers[name]["scale"]
        L, D, N = w.shape
        Np = _round_up(N, f_pad if name in ("gate_proj", "up_proj") else block_n)
        nc = Np // block_n
        q8c = torch.zeros((L, nc, D, block_n), dtype=w.dtype, device=w.device)
        for j in range(nc):
            n0, n1 = j * block_n, min(N, (j + 1) * block_n)
            if n1 > n0:
                q8c[:, j, :, : n1 - n0] = w[:, :, n0:n1]
        scale = torch.zeros((L, Np), dtype=torch.float32, device=s.device)
        scale[:, :N] = s
        out[name] = {"q8c": q8c, "scale": scale}
    wd = layers["down_proj"]["q8"]
    L, F, D = wd.shape
    Fp = _round_up(F, f_pad)
    q8r = torch.zeros((L, Fp, D), dtype=wd.dtype, device=wd.device)
    q8r[:, :F] = wd
    out["down_proj"] = {"q8r": q8r.reshape(L, Fp // block_f, block_f, D),
                        "scale": layers["down_proj"]["scale"].float()}
    for name, v in layers.items():
        if name not in out:
            out[name] = v
    return out


def unpack_serving_weights(packed: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of pack_serving_weights, padding kept (conversion and
    tests only: a 7B unpack doubles the weight memory). down_proj comes back
    as {"q8r_unpacked": [L, Fp, D]}, as in JAX."""
    out: Dict[str, Any] = {}
    for name in COL_MATS:
        wc = packed[name]["q8c"]
        L, nc, D, BN = wc.shape
        out[name] = {"q8": wc.permute(0, 2, 1, 3).reshape(L, D, nc * BN),
                     "scale": packed[name]["scale"]}
    wd = packed["down_proj"]["q8r"]
    L, ncf, BF, D = wd.shape
    out["down_proj"] = {"q8r_unpacked": wd.reshape(L, ncf * BF, D),
                        "scale": packed["down_proj"]["scale"]}
    for name in ("attn_norm", "mlp_norm"):
        out[name] = packed[name]
    return out


def pack_unified_kv(prompt_kv: Dict[str, torch.Tensor],
                    gen_slots: int) -> Tuple[Dict[str, torch.Tensor], int]:
    """Int8 split cache {"k", "k_scale", "v", "v_scale"} [L, B, S, KH, hd] ->
    (the unified slab, S0 = S): head-major, k and v side by side, zero past S,
    Sp = round_up(S + gen_slots, 128)."""
    k = prompt_kv["k"]
    L, B, S, KH, hd = k.shape
    Sp = _round_up(S + gen_slots, 128)
    kv = torch.zeros((L, B, 2, KH, Sp, hd), dtype=k.dtype, device=k.device)
    kvsc = torch.zeros((L, B, 2, KH, Sp), dtype=torch.float32, device=k.device)
    for i, name in enumerate(("k", "v")):
        kv[:, :, i, :, :S] = prompt_kv[name].permute(0, 1, 3, 2, 4)
        kvsc[:, :, i, :, :S] = prompt_kv[f"{name}_scale"].permute(0, 1, 3, 2)
    return {"kv": kv, "kvsc": kvsc}, S


def land_new_kv(slab: Dict[str, torch.Tensor], newkv: torch.Tensor, s0: int,
                step: int) -> Dict[str, torch.Tensor]:
    """Quantize this step's k/v (newkv [L, 2, B, KH, hd]; absmax over hd, as
    the prompt's) and write them IN PLACE into the slab at position s0 +
    step. Returns the slab."""
    xf = newkv.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    sc = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q8 = torch.div(xf, sc).round_().clamp_(-127, 127).to(torch.int8)
    idx = s0 + int(step)
    slab["kv"][:, :, :, :, idx] = q8.permute(0, 2, 1, 3, 4)
    slab["kvsc"][:, :, :, :, idx] = sc[..., 0].permute(0, 2, 1, 3)
    return slab


def supports_serve(cfg, params_or_packed) -> bool:
    """The shapes row 10 covers (others take decode_step_split): MHA,
    full-head non-interleaved rope, no bias, int8, and D a whole number of
    column chunks."""
    if cfg.num_heads != cfg.num_kv_heads or cfg.qkv_bias:
        return False
    if cfg.rope_interleaved or cfg.rope_fraction < 1.0:
        return False
    lp = params_or_packed.get("layers", params_or_packed)
    qp = lp.get("q_proj")
    if not (isinstance(qp, dict) and ("q8c" in qp or "q8" in qp)):
        return False
    if "q8c" in qp:
        _, ncD, D, BN = qp["q8c"].shape
        if ncD * BN != D:
            return False
    return True


def decode_step_serve_plain(
    packed: Dict[str, Any],
    slab: Dict[str, torch.Tensor],
    prompt_lens: torch.Tensor,
    step: int,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    s0: int,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Row 10's arithmetic step by step (revisionllm_tpu/ops/decode_serve.py:
    285-465): h rounds to bf16 before each weight dot; int8 weights are
    exact, each column chunk's product accumulates in f32, then times its
    scale; q, k, v stay f32; rope in f32; scores bf16 q . int8 K * k_scale *
    hd^-0.5 over one range of the slab, masked to s < plen_b or S0 <= s <
    S0 + step; the self term f32 q . k_new; one shared max; p * v_scale
    rounded to bf16 before the value dot; o = (o1 + ps * v) / denom; the
    residual rounded to x's type after each add; m = bf16(silu(g)), then
    bf16(m * u); down accumulated in f32 over the row chunks, then times the
    scale. The padded columns and rows are computed, not skipped. Lands this
    step's k/v at s0 + step and returns (hidden [B, D] in x's type, slab)."""
    L = packed["q_proj"]["q8c"].shape[0]
    B, D = x.shape
    kv, kvsc = slab["kv"], slab["kvsc"]
    H, Sp, hd = kv.shape[3], kv.shape[4], kv.shape[5]
    scale = hd ** -0.5
    dev = x.device
    cos_full = torch.cat([cos, cos], dim=-1).float().repeat(1, H)   # [B, H * hd]
    sin_full = torch.cat([sin, sin], dim=-1).float().repeat(1, H)
    pos = torch.arange(Sp, device=dev)[None, None, :]
    valid = (pos < prompt_lens.to(dev)[:, None, None]) | ((pos >= s0) & (pos < s0 + step))

    def cols(h_bf, name, l):
        w = packed[name]
        acc = torch.einsum("bk,ckn->bcn", h_bf.float(), w["q8c"][l].float())
        return acc.reshape(B, -1) * w["scale"][l].float()

    def rope(t):
        t3 = t.reshape(B, H, hd)
        rot = torch.cat([-t3[..., hd // 2:], t3[..., : hd // 2]], dim=-1).reshape(B, D)
        return t * cos_full + rot * sin_full

    newkv = torch.empty((L, 2, B, H, hd), dtype=torch.float32, device=dev)
    xres = x.clone()
    for l in range(L):
        h = _rms_norm_bf16(xres, packed["attn_norm"][l], eps)
        q = rope(cols(h, "q_proj", l)).reshape(B, H, hd)
        k = rope(cols(h, "k_proj", l)).reshape(B, H, hd)
        v = cols(h, "v_proj", l).reshape(B, H, hd)
        newkv[l, 0], newkv[l, 1] = k, v
        qb = q.to(torch.bfloat16).float()
        s1 = torch.einsum("bhd,bhsd->bhs", qb, kv[l, :, 0].float()) * kvsc[l, :, 0] * scale
        s1 = torch.where(valid, s1, torch.full_like(s1, NEG_INF))
        s_self = (q * k).sum(dim=-1, keepdim=True) * scale
        m = torch.maximum(s1.amax(-1, keepdim=True), s_self)
        p1, ps = torch.exp(s1 - m), torch.exp(s_self - m)
        denom = p1.sum(-1, keepdim=True) + ps
        p1v = (p1 * kvsc[l, :, 1]).to(torch.bfloat16).float()
        o1 = torch.einsum("bhs,bhsd->bhd", p1v, kv[l, :, 1].float())
        attn = ((o1 + ps * v) / denom).reshape(B, D).to(torch.bfloat16)
        xres = (xres.float() + cols(attn, "o_proj", l)).to(x.dtype)
        h = _rms_norm_bf16(xres, packed["mlp_norm"][l], eps)
        g = cols(h, "gate_proj", l)
        mbuf = (g * torch.sigmoid(g)).to(torch.bfloat16)
        mbuf = (mbuf.float() * cols(h, "up_proj", l)).to(torch.bfloat16)
        q8r = packed["down_proj"]["q8r"][l]   # [ncf, BF, D]
        BF = q8r.shape[1]
        yacc = mbuf[:, :BF].float() @ q8r[0].float()
        for j in range(1, q8r.shape[0]):
            yacc = yacc + mbuf[:, j * BF:(j + 1) * BF].float() @ q8r[j].float()
        xres = (xres.float() + yacc * packed["down_proj"]["scale"][l].float()).to(x.dtype)
    return xres, land_new_kv(slab, newkv, s0, step)


def decode_step_serve(
    packed: Dict[str, Any],
    slab: Dict[str, torch.Tensor],
    prompt_lens: torch.Tensor,
    step: int,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    s0: int,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step over the packed layer tree (`packed`, the
    pack_serving_weights output) and the unified slab: JAX's signature
    without the TPU's `nb` and `interpret`.

    x [B, D] (the current token's embedding, before layer 0); cos/sin [B,
    hd/2] f32 at each row's position; prompt_lens [B] (each <= s0). Returns
    (hidden [B, D] -- the final norm and the lm_head run outside -- and the
    slab, with this step's k/v landed at s0 + step).

    A CPU tensor takes `decode_step_serve_plain`; a CUDA tensor launches row
    10 once per 64 rows, or raises on a shape outside its scope or an input
    that requires grad."""
    if x.device.type == "cpu":
        return decode_step_serve_plain(packed, slab, prompt_lens, step, x, cos, sin, s0, eps)
    names = COL_MATS + ("down_proj",)
    ws = [packed[n]["q8c"] for n in COL_MATS] + [packed["down_proj"]["q8r"]]
    scales = [packed[n]["scale"] for n in names]
    norms = (packed["attn_norm"], packed["mlp_norm"])
    kv, kvsc = slab["kv"], slab["kvsc"]
    kernels.forbid_grad("decode_step_serve", x, *scales, *norms)
    B, D = x.shape
    L, ncD, _, BN = ws[0].shape
    ncF = ws[4].shape[1]
    Fp = ncF * BN
    ncf, BF = ws[6].shape[1], ws[6].shape[2]
    Lk, Bk, two, H, Sp, hd = kv.shape
    dev = x.device
    step, s0 = int(step), int(s0)
    shapes = [(L, ncD, D, BN)] * 4 + [(L, ncF, D, BN)] * 2 + [(L, ncf, BF, D)]
    widths = [D] * 4 + [Fp] * 2 + [D]
    bf16 = (x, *norms)
    if not (
        hd == 128 and D == H * hd and ncD * BN == D and BN % 128 == 0 and ncf * BF == Fp
        and Fp % 16 == 0 and Lk == L and Bk == B and two == 2 and 0 <= step and s0 + step < Sp
        and attn_layout(s0 + step, _slices(D))[0] >= 1
        and step_smem_bytes(D, Fp, s0 + step) <= SMEM_MAX
        and kvsc.shape == (L, B, 2, H, Sp) and tuple(prompt_lens.shape) == (B,)
        and cos.shape == (B, hd // 2) and sin.shape == (B, hd // 2)
        and all(tuple(w.shape) == s and w.dtype == torch.int8 for w, s in zip(ws, shapes))
        and all(tuple(s.shape) == (L, n) and s.dtype == torch.float32
                for s, n in zip(scales, widths))
        and all(t.dtype == torch.bfloat16 for t in bf16) and kv.dtype == torch.int8
        and kvsc.dtype == torch.float32
        and all(t.device == dev and t.is_contiguous() and t.data_ptr() % 16 == 0
                for t in (*ws, *scales, *bf16, kv, kvsc)) and kvsc.numel() % 4 == 0
    ):
        raise ValueError(
            "decode_step_serve kernel takes the packed int8 Vicuna tree (MHA, head dim 128, "
            "block_n a multiple of 128 dividing D, Fp % 16 == 0), a unified slab [L, B, 2, H, "
            "Sp, 128] with s0 + step < Sp whose attention scratch fits shared memory, bf16 x "
            "[B, D] and f32 cos/sin [B, 64], contiguous and 16-byte aligned on one device; "
            f"got x {x.dtype} {tuple(x.shape)}, q8c {tuple(ws[0].shape)}, kv {kv.dtype} "
            f"{tuple(kv.shape)}, s0 {s0}, step {step}"
        )
    plen = prompt_lens.to(device=dev, dtype=torch.int32).contiguous()
    cos32, sin32 = cos.float().contiguous(), sin.float().contiguous()
    out = torch.empty_like(x)
    newkv = torch.empty((L, 2, B, H, hd), dtype=torch.float32, device=dev)
    xres = torch.empty((ROWS_PER_LAUNCH, D), dtype=torch.bfloat16, device=dev)
    act = torch.empty((ROWS_PER_LAUNCH, max(D, Fp)), dtype=torch.bfloat16, device=dev)
    part = torch.empty(
        (max(_slices(D) * 3 * D, _slices(D) * 2 * Fp, _slices(Fp) * D) * ROWS_PER_LAUNCH,),
        dtype=torch.float32, device=dev)
    wptrs = (ctypes.c_void_p * 7)(*[w.data_ptr() for w in ws])
    sptrs = (ctypes.c_void_p * 7)(*[s.data_ptr() for s in scales])
    fn = kernels.function(
        "decode_serve", "decode_step_serve",
        [ctypes.c_void_p] * 15 + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p],
    )
    for b0 in range(0, B, ROWS_PER_LAUNCH):
        nb = min(ROWS_PER_LAUNCH, B - b0)
        err = fn(
            ctypes.cast(wptrs, ctypes.c_void_p), ctypes.cast(sptrs, ctypes.c_void_p),
            norms[0].data_ptr(), norms[1].data_ptr(), kv.data_ptr(), kvsc.data_ptr(),
            newkv.data_ptr(), plen[b0:].data_ptr(), cos32[b0:].data_ptr(),
            sin32[b0:].data_ptr(), x[b0:].data_ptr(), out[b0:].data_ptr(), xres.data_ptr(),
            act.data_ptr(), part.data_ptr(),
            L, nb, B, b0, D, Fp, H, Sp, s0, step, BN, float(eps), kernels.stream_of(x),
        )
        kernels.check_launch("decode_step_serve", err)
        kernels.LAUNCHES["decode_step_serve"] += 1
    return out, land_new_kv(slab, newkv, s0, step)
