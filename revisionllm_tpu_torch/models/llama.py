"""LLaMA / Vicuna backbone in PyTorch: serving, and training with LoRA.

Counterpart of revisionllm_tpu/models/llama.py: RMSNorm pre-norm, RoPE,
MHA/GQA attention, SwiGLU MLP. Parameters keep JAX's layout, so a tree
converted by models/weights.py runs unchanged: matrices [in, out] stacked on
a leading L axis (dense tensors or {"q8", "scale"} dicts), norms [L, D].
`lax.scan` over layers becomes a Python loop over layer views.

Matmuls go through ops.quant.q8_apply (kernel K1 at M <= 256), prefill
attention through ops.flash_attention.attention (kernel K2 on the card), and
each decode step's attention is one ops.decode_attention launch per layer
(kernel K3). Training (`forward_hidden(trainable=True)`) applies LoRA in
line and takes ops.flash_attention.trainable_attention (the row-4 kernels);
`remat=True` recomputes each layer in the backward
(torch.utils.checkpoint, in place of jax.checkpoint). The shared-prefix
prefill (`prefill_shared_prefix`) runs the rows' common prompt prefix once
and the rest through ops.flash_attention.flash_attention_prefixed (row 6 on
the card). With REVISIONLLM_FUSED_MLP=1 every int8 MLP tail runs through
ops.quant.w8a8_mlp_fused (row 8 on the card). Int4 trees ({"q4", "scale4"})
run through the same dispatch (row 7), and so do the serving-packed chunks of
ops/decode_serve.py (ops.quant.q8c_apply); `prefill_kv(kv_slab_slots=G)`
writes that path's unified int8 KV slab.

The ChatGLM2 geometry (LlamaConfig.chatglm2_6b) adds q/k/v biases
(`qkv_bias`) and its rotary, half of each head's dims in interleaved pairs
(`rope_interleaved`, `rope_fraction`); a P-tuning prefix (models/prefix.py,
`prefix_kv`) is attended by every query position of every layer, un-roped,
through row 6 on the card (`flash_attention_prefixed`) or, when training,
the plain lse pieces and their merge under autograd; `prefill_kv` folds it
into the returned cache at positions [0, P).

`mesh=` (parallel/mesh.py) runs a rank's shards (parallel/sharding.py
shard_params) as one part of a sharded model: H / tp query heads and
KH / tp kv heads a rank, an all-reduce over `tensor` after o_proj and after
down_proj, the lm_head's vocabulary slices all-gathered before the f32
logits, and under fsdp each layer's shards all-gathered just before it runs
(inside the checkpoint when `remat`) and freed after it. Without a mesh, or
with one that splits only the batch, nothing of that runs.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from revisionllm_tpu_torch.config import LlamaConfig
from revisionllm_tpu_torch.ops.decode_attention import decode_attention
from revisionllm_tpu_torch.ops.flash_attention import (
    attention,
    flash_attention_prefixed,
    merge_attention_pieces,
    mha_reference_lse,
    trainable_attention,
)
from revisionllm_tpu_torch.ops.norms import rms_norm
from revisionllm_tpu_torch.ops.quant import (
    _is_q8,
    q8_apply,
    q8_apply_multi,
    quantize_activation_rows,
    quantize_int4,
    quantize_int8,
    row_absmax,
    w8a8_matmul_absmax,
    w8a8_mlp_fused,
    w8a8_prequant_matmul,
    w8a8_route,
)
from revisionllm_tpu_torch.ops.rope import (
    apply_rope_tables,
    rope_angles,
    rope_tables,
    rope_tables_interleaved,
)
from revisionllm_tpu_torch.parallel import comm
from revisionllm_tpu_torch.parallel.sharding import COLUMN_PARALLEL, ROW_PARALLEL, local_config
from revisionllm_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]

LAYER_MATRICES = {
    "q_proj": ("hidden", "q_out"),
    "k_proj": ("hidden", "kv_out"),
    "v_proj": ("hidden", "kv_out"),
    "o_proj": ("q_out", "hidden"),
    "gate_proj": ("hidden", "ffn"),
    "up_proj": ("hidden", "ffn"),
    "down_proj": ("ffn", "hidden"),
}

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else _DTYPES[name]


def _dims(cfg: LlamaConfig) -> Dict[str, int]:
    return {
        "hidden": cfg.hidden_size,
        "q_out": cfg.num_heads * cfg.head_dim,
        "kv_out": cfg.num_kv_heads * cfg.head_dim,
        "ffn": cfg.intermediate_size,
    }


def init_params(
    cfg: LlamaConfig,
    seed: int = 0,
    dtype=None,
    device=None,
    quantize: Union[bool, str] = False,
    quantize_lm_head: bool = True,
) -> Params:
    """Random init (scaled normal) from `seed`, on `device` (default CUDA).

    quantize=True (or "int8") draws one layer's matrix at a time and keeps
    only its int8 values and scales, so a 7B tree never holds a
    full-precision copy; quantize="int4" keeps group-128 int4 weights
    ({"q4", "scale4"}, as quantize_llama_params_int4). The lm_head is
    quantized too unless quantize_lm_head=False (the training base keeps a
    dense lm_head, as train_cli does), and the embedding keeps `dtype`. The
    numbers differ from the JAX package's init (another generator); parity
    tests carry JAX's weights across with models/weights.py instead."""
    device = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dims = _dims(cfg)
    L = cfg.num_layers
    fmt = {False: None, True: "int8", "int8": "int8", "int4": "int4"}[quantize]

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * std

    def matrix(n, din, dout, fmt=fmt):
        # one [din, dout] draw at a time, so a quantized tree holds at most
        # one layer's matrix in f32; n=None gives an unstacked matrix
        std = din ** -0.5
        if fmt == "int8":
            out = {
                "q8": torch.empty((n or 1, din, dout), dtype=torch.int8, device=device),
                "scale": torch.empty((n or 1, dout), dtype=torch.float32, device=device),
            }
        elif fmt == "int4":
            out = {
                "q4": torch.empty((n or 1, din // 2, dout), dtype=torch.uint8, device=device),
                "scale4": torch.empty((n or 1, din // 128, dout), dtype=torch.float32,
                                      device=device),
            }
        else:
            out = torch.empty((n or 1, din, dout), dtype=dtype, device=device)
        for i in range(n or 1):
            w = normal((din, dout), std)
            if fmt == "int8":
                out["q8"][i], out["scale"][i] = quantize_int8(w)
            elif fmt == "int4":
                out["q4"][i], out["scale4"][i] = quantize_int4(w)
            else:
                out[i] = w.to(dtype)
        if n is None:
            return {k: v[0] for k, v in out.items()} if fmt else out[0]
        return out

    layers: Params = {}
    for name, (din, dout) in LAYER_MATRICES.items():
        layers[name] = matrix(L, dims[din], dims[dout])
    layers["attn_norm"] = torch.ones((L, cfg.hidden_size), dtype=dtype, device=device)
    layers["mlp_norm"] = torch.ones((L, cfg.hidden_size), dtype=dtype, device=device)
    if cfg.qkv_bias:  # zeros, as JAX's init (llama.py:79-82)
        for name, width in (("q_bias", "q_out"), ("k_bias", "kv_out"), ("v_bias", "kv_out")):
            layers[name] = torch.zeros((L, dims[width]), dtype=dtype, device=device)
    return {
        "embed": normal((cfg.vocab_size, cfg.hidden_size), 0.02).to(dtype),
        "layers": layers,
        "final_norm": torch.ones((cfg.hidden_size,), dtype=dtype, device=device),
        "lm_head": matrix(None, cfg.hidden_size, cfg.vocab_size,
                          fmt if quantize_lm_head else None),
    }


def layer_params(params: Params, i: int, mesh=None) -> Params:
    """Views of layer i of the stacked layer tree (no copies). Under a mesh
    that splits the weights (model_mesh), a rank's shards: column-parallel
    matrices gathered over fsdp along their input dim (an int8 scale is not
    fsdp-sharded), row-parallel ones along their output dim, ChatGLM2's
    biases cut to this rank's heads."""
    out = {}
    for name, w in params["layers"].items():
        w = {k: t[i] for k, t in w.items()} if isinstance(w, dict) else w[i]
        if mesh is not None and name in COLUMN_PARALLEL:
            w = _gather_fsdp(w, mesh, 0, keep=("scale",))
        elif mesh is not None and name in ROW_PARALLEL:
            w = _gather_fsdp(w, mesh, -1)
        elif mesh is not None and name.endswith("_bias") and mesh.shape["tensor"] > 1:
            w = comm.local_slice(w, mesh, "tensor", 0)
        out[name] = w
    return out


def model_mesh(mesh):
    """`mesh` when it splits the weights (fsdp or tensor above 1), else
    None: a data-only or one-rank mesh runs the model as one process does."""
    if mesh is None or (mesh.shape["fsdp"] == 1 and mesh.shape["tensor"] == 1):
        return None
    return mesh


@torch.no_grad()
def _gather_fsdp(w, mesh, dim: int, keep=()):
    """A matrix's (or a quantized dict's) fsdp shards put together along
    `dim`; the leaves named in `keep` are not fsdp-sharded."""
    if mesh.shape["fsdp"] == 1:
        return w
    if isinstance(w, dict):
        return {k: t if k in keep else comm.all_gather(t, mesh, "fsdp", dim % t.dim())
                for k, t in w.items()}
    return comm.all_gather(w, mesh, "fsdp", dim % w.dim())


def _local_lora(lora_lp: Optional[Params], mesh) -> Optional[Params]:
    """A whole LoRA layer cut to this rank's slice of the base: b's output
    columns of a column-parallel matrix, a's input rows of a row-parallel
    one (autograd fills only that slice of the gradient)."""
    if lora_lp is None or mesh is None or mesh.shape["tensor"] == 1:
        return lora_lp
    out = {}
    for name, m in lora_lp.items():
        if name in COLUMN_PARALLEL:
            m = {"a": m["a"], "b": comm.local_slice(m["b"], mesh, "tensor", 1)}
        elif name in ROW_PARALLEL:
            m = {"a": comm.local_slice(m["a"], mesh, "tensor", 0), "b": m["b"]}
        out[name] = m
    return out


def _local_prefix(prefix_kv, mesh):
    """A P-tuning prefix (pk, pv) [L, 1, P, KH, hd] cut to this rank's kv
    heads."""
    if prefix_kv is None or mesh is None or mesh.shape["tensor"] == 1:
        return prefix_kv
    return tuple(comm.local_slice(t, mesh, "tensor", 3) for t in prefix_kv)


def embed_tokens(params: Params, ids: torch.Tensor, mesh=None) -> torch.Tensor:
    """Token ids -> embeddings; negative sentinel ids are clamped to 0.

    Under a mesh the table is [V / fsdp, D / tp]: the fsdp ranks' ids are
    gathered (their rows differ when fsdp splits the batch), each looks up
    the ids in its vocabulary rows (zero elsewhere), the sum over fsdp gives
    every row its embedding exactly, and the D slices are gathered over
    tensor."""
    mesh = model_mesh(mesh)
    ids = ids.clamp(min=0).long()
    if mesh is None:
        return params["embed"][ids]
    table = params["embed"]
    if mesh.shape["fsdp"] > 1:
        every = comm.all_gather(ids[None], mesh, "fsdp", 0)
        local = every - mesh.coord("fsdp") * table.shape[0]
        hit = (local >= 0) & (local < table.shape[0])
        e = table[local.clamp(0, table.shape[0] - 1)]
        e = torch.where(hit[..., None], e, torch.zeros_like(e))
        e = comm.all_reduce(e, mesh, "fsdp")[mesh.coord("fsdp")]
    else:
        e = table[ids]
    if mesh.shape["tensor"] > 1:
        e = comm.all_gather(e, mesh, "tensor", e.dim() - 1)
    return e


def _lora_apply(x, w, lora_layer, scale):
    """x @ W (q8_apply) plus scale * (x @ A) @ B. JAX's `x @ a` promotes a
    bf16 activation times the f32 adapter to f32, so the delta is computed
    in the promoted type and cast back to the output's."""
    y = q8_apply(x, w)
    if lora_layer is not None:
        a, b = lora_layer["a"], lora_layer["b"]
        dt = torch.promote_types(x.dtype, a.dtype)
        delta = (x.to(dt) @ a.to(dt)) @ b.to(dt) * scale
        y = y + delta.to(y.dtype)
    return y


def _rotary_dim(cfg: LlamaConfig) -> int:
    return int(cfg.head_dim * cfg.rope_fraction)


def rope_for(cfg: LlamaConfig, positions: torch.Tensor):
    """The rotary tables of `positions` [..., T] for cfg's convention, the
    arguments after x of ops.rope.apply_rope_tables: half-split over the
    whole head (Vicuna), or ChatGLM2's interleaved pairs over its first
    rotary_dim dims (JAX's _rope, llama.py:140-151)."""
    cos, sin = rope_angles(positions, _rotary_dim(cfg), cfg.rope_theta)
    if cfg.rope_interleaved or cfg.rope_fraction < 1.0:
        return (*rope_tables_interleaved(cos, sin, cfg.head_dim), True)
    return (*rope_tables(cos, sin), False)


def _qkv_bias(cfg: LlamaConfig, lp, q, k, v):
    """q [.., H, hd], k/v [.., KH, hd] plus ChatGLM2's biases (qkv_bias)."""
    if not cfg.qkv_bias:
        return q, k, v
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return (q + lp["q_bias"].reshape(H, hd), k + lp["k_bias"].reshape(KH, hd),
            v + lp["v_bias"].reshape(KH, hd))


def _prefix_attention(q, k, v, pk, pv, kv_lens, trainable):
    """Attention over [the P-tuning prefix pk/pv [1, P, KH, hd], visible to
    every row and query | the row's own causal k/v]: row 6 on the card
    (the prefix in q's type), its plain version on the CPU; when training,
    the plain lse pieces and their merge, which autograd differentiates into
    the prefix (JAX's use_pallas=False branch, llama.py:208-215)."""
    if not trainable:
        return flash_attention_prefixed(q, k, v, pk.to(q.dtype).contiguous(),
                                        pv.to(q.dtype).contiguous(), kv_lens=kv_lens)
    B = q.shape[0]
    o1, lse1 = mha_reference_lse(q, pk.expand((B,) + tuple(pk.shape[1:])),
                                 pv.expand((B,) + tuple(pv.shape[1:])), causal=False)
    o2, lse2 = mha_reference_lse(q, k, v, causal=True, kv_lens=kv_lens)
    return merge_attention_pieces(o1, lse1, o2, lse2)


def _row_parallel(x, w, lora_lp, lora_scale, mesh):
    """x [..., K / tp] times this rank's rows of a row-parallel matrix (plus
    its LoRA slice), summed over tensor in f32. On the W8A8 route the
    activation rows are quantized by their absmax over the whole K (one
    max-reduce of M floats) and the int32 partial products are summed
    before the scales, which gives the one-process product bit for bit."""
    if mesh is None or mesh.shape["tensor"] == 1:
        return _lora_apply(x, w, lora_lp, lora_scale)
    if lora_lp is None and w8a8_route(x, w):
        amax = comm.all_reduce(row_absmax(x), mesh, "tensor", op="max")
        return w8a8_matmul_absmax(x, w["q8"], w["scale"], amax,
                                  reduce=lambda acc: comm.all_reduce(acc, mesh, "tensor"))
    return comm.reduce_from_tensor(_lora_apply(x, w, lora_lp, lora_scale), mesh)


def _attention_block(cfg, lp, x, rope, kv_lens, lora_lp=None, lora_scale=0.0, trainable=False,
                     prefix_pkv=None, mesh=None):
    B, T, _ = x.shape
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = comm.copy_to_tensor(x, mesh)
    if lora_lp is None:
        qm, km, vm = q8_apply_multi(x, (lp["q_proj"], lp["k_proj"], lp["v_proj"]))
    else:
        qm, km, vm = (_lora_apply(x, lp[n], lora_lp.get(n), lora_scale)
                      for n in ("q_proj", "k_proj", "v_proj"))
    q, k, v = _qkv_bias(cfg, lp, qm.reshape(B, T, H, hd), km.reshape(B, T, KH, hd),
                        vm.reshape(B, T, KH, hd))
    q = apply_rope_tables(q, *rope)
    k = apply_rope_tables(k, *rope)
    if prefix_pkv is not None:
        o = _prefix_attention(q, k, v, *prefix_pkv, kv_lens, trainable)
    elif trainable:
        o = trainable_attention(q, k, v, causal=True, kv_lens=kv_lens)
    else:
        o = attention(q, k, v, causal=True, kv_lens=kv_lens)
    o = o.reshape(B, T, H * hd)
    lo = None if lora_lp is None else lora_lp.get("o_proj")
    return _row_parallel(o, lp["o_proj"], lo, lora_scale, mesh), k, v


_FUSED_MLP: Optional[bool] = None


def set_fused_mlp(enabled: Optional[bool]) -> None:
    """Override the fused-MLP switch (None = back to the environment)."""
    global _FUSED_MLP
    _FUSED_MLP = enabled


def _fused_mlp_enabled() -> bool:
    """REVISIONLLM_FUSED_MLP=1 (default off, as in JAX): the SwiGLU tail of
    every int8 MLP runs through ops.quant.w8a8_mlp_fused."""
    if _FUSED_MLP is not None:
        return _FUSED_MLP
    return os.environ.get("REVISIONLLM_FUSED_MLP", "0") == "1"


def _mlp_block(lp, x, lora_lp=None, lora_scale=0.0, mesh=None):
    x = comm.copy_to_tensor(x, mesh)
    if lora_lp is None:
        if _fused_mlp_enabled() and _is_q8(lp["gate_proj"]) and _is_q8(lp["down_proj"]):
            # JAX's fused branch (llama.py:238-262): it checks neither W8A8
            # nor M, so the decode step takes it too when the megakernel is
            # off. The down_proj input leaves row 8 already quantized (per
            # rank's F / tp columns under tensor parallelism)
            x2 = x.reshape(-1, x.shape[-1])
            xq, xs = quantize_activation_rows(x2)
            hq, hs = w8a8_mlp_fused(xq, xs, lp["gate_proj"]["q8"], lp["gate_proj"]["scale"],
                                    lp["up_proj"]["q8"], lp["up_proj"]["scale"])
            # summed over tensor in f32, then rounded once
            out = w8a8_prequant_matmul(hq, hs, lp["down_proj"]["q8"], lp["down_proj"]["scale"],
                                       out_dtype=x.dtype if mesh is None else torch.float32)
            out = out.reshape(*x.shape[:-1], out.shape[-1])
            return comm.reduce_from_tensor(out, mesh).to(x.dtype)
        g_lin, up = q8_apply_multi(x, (lp["gate_proj"], lp["up_proj"]))
        return _row_parallel(F.silu(g_lin) * up, lp["down_proj"], None, 0.0, mesh)
    g_lin, up = (_lora_apply(x, lp[n], lora_lp.get(n), lora_scale) for n in ("gate_proj", "up_proj"))
    return _row_parallel(F.silu(g_lin) * up, lp["down_proj"], lora_lp.get("down_proj"),
                         lora_scale, mesh)


def lora_layer_params(lora: Optional[Params], i: int) -> Optional[Params]:
    """Views of layer i of a LoRA tree (models/lora.py), or None."""
    if lora is None:
        return None
    return {name: {k: t[i] for k, t in mats.items()} for name, mats in lora["layers"].items()}


def _quantize_rows(x: torch.Tensor):
    """absmax-int8 over the last axis: (int8 values, f32 scale with the last
    axis reduced to 1)."""
    # abs and max are exact in x's own type; x / sc promotes to f32
    absmax = x.abs().amax(dim=-1, keepdim=True).float()
    sc = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    return torch.div(x, sc).round_().clamp_(-127, 127).to(torch.int8), sc


def forward_hidden(
    cfg: LlamaConfig,
    params: Params,
    embeds: torch.Tensor,
    positions: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    return_kv: bool = False,
    kv_quant: bool = False,
    lora: Optional[Params] = None,
    lora_scale: float = 0.0,
    trainable: bool = False,
    remat: bool = False,
    kv_slab_slots: Optional[int] = None,
    prefix_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    mesh=None,
):
    """Full-sequence forward. embeds [B, T, D], positions [B, T].

    Returns the final hidden [B, T, D]; with return_kv=True also the
    per-layer cache {"k", "v"} [L, B, T, KH, hd], which kv_quant=True writes
    as int8 plus per-(position, head) scales {"k_scale", "v_scale"}
    [L, B, T, KH] layer by layer, so a full-precision cache never exists.
    kv_slab_slots=G (with kv_quant) writes the same int8 values and scales
    straight into the unified serving slab of ops.decode_serve instead,
    {"kv": [L, B, 2, KH, Sp, hd] int8, "kvsc": [L, B, 2, KH, Sp] f32} with
    Sp = round_up(T + G, 128), zero past T: the split cache is never
    allocated beside it.

    Training: `lora` (models/lora.py tree) adds scale * x A B to every
    adapted matmul; trainable=True takes the differentiable attention
    (row-4 kernels on the card); remat=True checkpoints each layer, which is
    exact because the layers draw no random numbers.

    prefix_kv: a P-tuning prefix (pk, pv) [L, 1, P, KH, hd]
    (models.prefix.prefix_kv), prepended un-roped to every layer's keys and
    values and visible to every query; positions are not shifted. The
    returned cache holds the tokens' k/v only (prefill_kv folds the
    prefix in).

    mesh: params are a rank's shards (module docstring); the cache holds
    this rank's kv heads."""
    if remat and return_kv:
        raise ValueError("remat is for training; it returns no cache")
    mesh = model_mesh(mesh)
    cfg = local_config(cfg, mesh)
    prefix_kv = _local_prefix(prefix_kv, mesh)
    B, T, _ = embeds.shape
    L, KH, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    rope = rope_for(cfg, positions)
    cache = None
    if kv_slab_slots is not None:
        assert kv_quant, "kv_slab_slots requires kv_quant=True"
        Sp = -(-(T + kv_slab_slots) // 128) * 128
        cache = {
            "kv": torch.zeros((L, B, 2, KH, Sp, hd), dtype=torch.int8, device=embeds.device),
            "kvsc": torch.zeros((L, B, 2, KH, Sp), dtype=torch.float32, device=embeds.device),
        }
    elif return_kv:
        kv_dtype = torch.int8 if kv_quant else embeds.dtype
        shape = (L, B, T, KH, hd)
        cache = {
            "k": torch.empty(shape, dtype=kv_dtype, device=embeds.device),
            "v": torch.empty(shape, dtype=kv_dtype, device=embeds.device),
        }
        if kv_quant:
            cache["k_scale"] = torch.empty(shape[:-1], dtype=torch.float32, device=embeds.device)
            cache["v_scale"] = torch.empty(shape[:-1], dtype=torch.float32, device=embeds.device)
    def layer(x, lp, lora_lp, ppkv):
        h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        attn_out, k, v = _attention_block(cfg, lp, h, rope, kv_lens, lora_lp, lora_scale, trainable,
                                          ppkv, mesh)
        x = x + attn_out
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
        return x + _mlp_block(lp, h, lora_lp, lora_scale, mesh), k, v

    x = embeds
    for i in range(L):
        lora_lp = _local_lora(lora_layer_params(lora, i), mesh)
        ppkv = None if prefix_kv is None else (prefix_kv[0][i], prefix_kv[1][i])
        if remat:
            # the layer's fsdp gather runs inside the checkpoint, so the
            # gathered weights are not kept for the backward
            x = checkpoint(lambda x, ppkv, i=i, lora_lp=lora_lp:
                           layer(x, layer_params(params, i, mesh), lora_lp, ppkv)[0],
                           x, ppkv, use_reentrant=False)
            continue
        x, k, v = layer(x, layer_params(params, i, mesh), lora_lp, ppkv)
        if kv_slab_slots is not None:
            for j, t in enumerate((k, v)):
                tq, ts = _quantize_rows(t)
                cache["kv"][i, :, j, :, :T] = tq.permute(0, 2, 1, 3)
                cache["kvsc"][i, :, j, :, :T] = ts[..., 0].permute(0, 2, 1)
        elif cache is not None:
            if kv_quant:
                for name, t in (("k", k), ("v", v)):
                    tq, ts = _quantize_rows(t)
                    cache[name][i] = tq
                    cache[f"{name}_scale"][i] = ts[..., 0]
            else:
                cache["k"][i] = k
                cache["v"][i] = v
    hidden = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    if return_kv or kv_slab_slots is not None:
        return hidden, cache
    return hidden


def logits_from_hidden(params: Params, hidden: torch.Tensor, mesh=None) -> torch.Tensor:
    """LM head, returned in f32 (decode entropy needs full-precision logits).
    Under a mesh the lm_head is [D / fsdp, V / tp]: its fsdp shards are
    gathered, and each rank's vocabulary columns all-gathered over tensor
    before the cast."""
    mesh = model_mesh(mesh)
    if mesh is None:
        return q8_apply(hidden, params["lm_head"]).float()
    w = _gather_fsdp(params["lm_head"], mesh, 0, keep=("scale",))
    y = q8_apply(comm.copy_to_tensor(hidden, mesh), w)
    return comm.gather_from_tensor(y, mesh).float()


def prefill_kv(
    cfg: LlamaConfig,
    params: Params,
    embeds: torch.Tensor,
    positions: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    kv_quant: bool = False,
    kv_slab_slots: Optional[int] = None,
    prefix_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    mesh=None,
) -> Tuple[torch.Tensor, Params]:
    """Prefill: (logits at each row's last position [B, V], read-only prompt
    cache {"k", "v"[, "k_scale", "v_scale"]} [L, B, T, KH, hd]).
    kv_slab_slots=G (with kv_quant) returns the unified serving slab
    {"kv", "kvsc"} of ops.decode_serve with G generation slots (s0 = T)
    instead of the split cache.

    prefix_kv: a P-tuning prefix (pk, pv) [L, 1, P, KH, hd], attended in
    the prefill and folded into the returned cache at positions [0, P) in
    embeds' type (int8 with its scales under kv_quant), so the cache is
    [L, B, P + T, KH, hd]; decode then masks with mask_lens = kv_lens + P
    and keeps the rope positions on kv_lens (decode_step_split). The serve
    slab takes no prefix (JAX's llama.py:528)."""
    if prefix_kv is not None and kv_slab_slots is not None:
        raise ValueError("P-tuning prefix is not supported with the serve slab")
    hidden, cache = forward_hidden(
        cfg, params, embeds, positions, kv_lens, return_kv=True, kv_quant=kv_quant,
        kv_slab_slots=kv_slab_slots, prefix_kv=prefix_kv, mesh=mesh,
    )
    if prefix_kv is not None:
        B = embeds.shape[0]
        pkb, pvb = (t.expand((t.shape[0], B) + tuple(t.shape[2:])).to(embeds.dtype)
                    for t in _local_prefix(prefix_kv, model_mesh(mesh)))
        head = quantize_prompt_kv({"k": pkb, "v": pvb}) if kv_quant else {"k": pkb, "v": pvb}
        cache = {name: torch.cat([head[name], t], dim=2) for name, t in cache.items()}
    if kv_lens is None:
        last = hidden[:, -1]
    else:
        idx = (kv_lens.long() - 1).clamp(min=0)
        last = hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]
    return logits_from_hidden(params, last, mesh), cache


def prefill_shared_prefix(
    cfg: LlamaConfig,
    params: Params,
    embeds: torch.Tensor,
    positions: torch.Tensor,
    prefix_len: int,
    kv_lens: Optional[torch.Tensor] = None,
    kv_quant: bool = False,
    mesh=None,
) -> Tuple[torch.Tensor, Params]:
    """Prefill where every row shares its first `prefix_len` embeddings (the
    engine's window batches share their prompt up to the video block).

    The prefix runs once at B = 1 (K1 and K2 on the card); each layer of the
    rest [B, T - P] attends to [the prefix kv | its own causal block]
    through `flash_attention_prefixed` (row 6 on the card, two lse pieces
    and a merge on the CPU). Returns what `prefill_kv` returns: logits at
    each row's last position and the prompt cache [L, B, T, KH, hd], the
    prefix broadcast and then the rest. kv_quant=True quantizes it layer by
    layer (per (position, head) scales, the same numbers as JAX's quantizing
    the whole bf16 cache at the end), so the full bf16 cache never exists."""
    mesh = model_mesh(mesh)
    B, T, _ = embeds.shape
    P = prefix_len
    _, prefix_kv = forward_hidden(cfg, params, embeds[:1, :P], positions[:1, :P], return_kv=True,
                                  mesh=mesh)
    cfg = local_config(cfg, mesh)
    L, H, KH, hd = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    T2 = T - P
    rope = rope_for(cfg, positions[:, P:])
    rest_lens = None if kv_lens is None else (kv_lens.to(torch.int32) - P).clamp(min=0)
    kv_dtype = torch.int8 if kv_quant else embeds.dtype
    cache = {n: torch.empty((L, B, T, KH, hd), dtype=kv_dtype, device=embeds.device)
             for n in ("k", "v")}
    if kv_quant:
        for n in ("k", "v"):
            cache[f"{n}_scale"] = torch.empty((L, B, T, KH), dtype=torch.float32,
                                              device=embeds.device)

    def store(i, name, prefix, rest):
        """Layer i of the cache: the prefix [1, P, KH, hd] broadcast over the
        rows, then the rest [B, T2, KH, hd]."""
        for sl, t in ((slice(0, P), prefix), (slice(P, T), rest)):
            if kv_quant:
                tq, ts = _quantize_rows(t)
                cache[name][i, :, sl] = tq
                cache[f"{name}_scale"][i, :, sl] = ts[..., 0]
            else:
                cache[name][i, :, sl] = t

    x = embeds[:, P:]
    for i in range(L):
        lp = layer_params(params, i, mesh)
        pk, pv = prefix_kv["k"][i], prefix_kv["v"][i]
        h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        qm, km, vm = q8_apply_multi(h, (lp["q_proj"], lp["k_proj"], lp["v_proj"]))
        q, k, v = _qkv_bias(cfg, lp, qm.reshape(B, T2, H, hd), km.reshape(B, T2, KH, hd),
                            vm.reshape(B, T2, KH, hd))
        q = apply_rope_tables(q, *rope)
        k = apply_rope_tables(k, *rope)
        o = flash_attention_prefixed(q, k, v, pk, pv, kv_lens=rest_lens)
        x = x + _row_parallel(o.reshape(B, T2, H * hd), lp["o_proj"], None, 0.0, mesh)
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
        x = x + _mlp_block(lp, h, mesh=mesh)
        store(i, "k", pk, k)
        store(i, "v", pv, v)
    hidden = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    if kv_lens is None:
        last = hidden[:, -1]
    else:
        idx = (kv_lens.long() - 1 - P).clamp(min=0)
        last = hidden[torch.arange(B, device=hidden.device), idx]
    return logits_from_hidden(params, last, mesh), cache


def init_gen_cache(cfg: LlamaConfig, batch: int, slots: int, dtype, device) -> Params:
    """Zeroed generated-token cache {"k", "v"} [L, B, G, KH, hd]."""
    shape = (cfg.num_layers, batch, slots, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def decode_step_split(
    cfg: LlamaConfig,
    params: Params,
    prompt_kv: Params,
    prompt_lens: torch.Tensor,
    gen_cache: Params,
    step: int,
    token_embeds: torch.Tensor,
    mask_lens: Optional[torch.Tensor] = None,
    mesh=None,
) -> Tuple[torch.Tensor, Params]:
    """One decode step with the split KV layout.

    prompt_kv [L, B, S, KH, hd] stays read-only after prefill; this step's
    k/v land in gen_cache [L, B, G, KH, hd] at slot `step`, written IN PLACE
    (JAX returns an updated copy; the returned dict is the same tensors).
    Attention over [prompt | generated] is one decode_attention call per
    layer. mask_lens: valid prompt positions per row (default prompt_lens;
    prompt_lens + P over a cache with a P-tuning prefix folded in, whose
    rope positions stay on prompt_lens).
    Returns (logits [B, V] f32, gen_cache)."""
    mesh = model_mesh(mesh)
    cfg = local_config(cfg, mesh)
    B = token_embeds.shape[0]
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    group = H // KH
    positions = (prompt_lens.long() + step)[:, None]
    rope = rope_for(cfg, positions)
    if mask_lens is None:
        mask_lens = prompt_lens
    quantized = "k_scale" in prompt_kv

    x = token_embeds
    for i in range(cfg.num_layers):
        lp = layer_params(params, i, mesh)
        h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv_bias(cfg, lp, q8_apply(h, lp["q_proj"]).reshape(B, 1, H, hd),
                            q8_apply(h, lp["k_proj"]).reshape(B, 1, KH, hd),
                            q8_apply(h, lp["v_proj"]).reshape(B, 1, KH, hd))
        q = apply_rope_tables(q, *rope)
        k = apply_rope_tables(k, *rope)
        gk, gv = gen_cache["k"][i], gen_cache["v"][i]
        gk[:, step] = k[:, 0].to(gk.dtype)
        gv[:, step] = v[:, 0].to(gv.dtype)
        o = decode_attention(
            q.reshape(B, KH, group, hd),
            prompt_kv["k"][i], prompt_kv["v"][i],
            prompt_kv["k_scale"][i] if quantized else None,
            prompt_kv["v_scale"][i] if quantized else None,
            gk, gv, mask_lens, step,
        )
        x = x + _row_parallel(o.reshape(B, 1, H * hd).to(x.dtype), lp["o_proj"], None, 0.0, mesh)
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
        x = x + _mlp_block(lp, h, mesh=mesh)
    hidden = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return logits_from_hidden(params, hidden[:, 0], mesh), gen_cache


def quantize_prompt_kv(prompt_kv: Params) -> Params:
    """Int8 prompt KV: per-(layer, batch, position, head) absmax over hd."""
    out = {}
    for name in ("k", "v"):
        q, sc = _quantize_rows(prompt_kv[name])
        out[name] = q
        out[f"{name}_scale"] = sc[..., 0]
    return out
