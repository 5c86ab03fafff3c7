"""LLaMA / Vicuna backbone in PyTorch: serving, and training with LoRA.

Counterpart of revisionllm_tpu/models/llama.py. Parameters keep JAX's
layout, so a tree converted by models/weights.py runs unchanged: matrices
[in, out] stacked on a leading L axis (dense, {"q8", "scale"}, int4
{"q4", "scale4"} or the serving-packed chunks of ops/decode_serve.py),
norms [L, D]. `lax.scan` over layers becomes a Python loop over layer views.

One dense layer, `_dense_layer`, serves every dense path: RMSNorm; q/k/v
through ops.quant.q8_apply_multi (K1 at M <= 256, the W8A8 GEMM above it;
LoRA's adapted matmuls when training); ChatGLM2's q/k/v biases; rope
(`rope_for`: half-split over the head, or ChatGLM2's interleaved pairs
over half of it); the attention; o_proj and the residual; RMSNorm,
`_mlp_block` (SwiGLU; row 8 under REVISIONLLM_FUSED_MLP=1) and the
residual. Only the attention varies, passed in as a function of the roped
q, k and v:

- a prompt (`forward_hidden`, `prefill_kv`): causal over its own k/v (K2
  on the card; the row-4 kernels with `trainable=True`, each layer
  checkpointed with `remat`), behind an attended prefix when one is given
  (row 6, `flash_attention_prefixed`): a P-tuning prefix (models/prefix.py),
  un-roped and seen by every query, or
- the shared prefix (`prefill_shared_prefix`): the rows' common prompt
  prefix runs once at B = 1, and the rest attends that pass's k/v;
- a decode step (`decode_step_split`): this step's k/v into slot `step` of
  the generated cache, then one decode_attention (K3) over [the prompt
  cache | the generated slots].

One prompt-cache writer, `_write_prompt_kv`, writes a layer's k and v at
positions [start, start + n) in the layout `prompt_cache_layout` names:
{"k", "v"} [L, B, S, KH, hd] in the model's type, int8 rows with
per-(position, head) scales under KV8, or row 10's unified int8 slab
{"kv", "kvsc"}. A prefill writes an attended prefix at [0, P) once for all
layers and each layer's tokens after it as the layer ends, into new
tensors or into the `kv_out` it is given (a decode graph set's buffers,
models/generation.py).

DeepSeek-V2 (config.DeepseekV2Config, `cfg.latent_attention`) takes its
own layers behind the same entry points: multi-head latent attention (MLA),
decompressed in the prefill (`_mla_prefill_layer`) and absorbed into the
latent in decode (`_mla_decode_layer`), over a bf16 latent cache {"latent"
[L, B, S, kv_lora_rank + qk_rope_head_dim]} in place of k/v; the first
`first_k_dense_replace` layers' MLP dense ("dense"), the rest DeepSeekMoE
(ops/moe.py, "moe"). Each layer's attention and MoE, with their norms and
residual adds, are the spans `model.mla` and `model.moe`; a decode step is
a list of such pieces (`mla_decode_pieces`) that models/generation.py
replays as CUDA graphs on the card. Meshes that split the weights, P-tuning
prefixes, the shared-prefix prefill, rows 8-10 and training raise for it.

`mesh=` (parallel/mesh.py) runs a rank's shards (parallel/sharding.py
shard_params) as one part of a sharded model: H / tp query heads and
KH / tp kv heads a rank, an all-reduce over `tensor` after o_proj and after
down_proj, the lm_head's vocabulary slices all-gathered before the f32
logits, and under fsdp each layer's shards all-gathered just before it runs
(inside the checkpoint when `remat`) and freed after it. Without a mesh, or
with one that splits only the batch, nothing of that runs.
"""

from __future__ import annotations

import contextlib
import functools
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
from revisionllm_tpu_torch.ops import moe as MOE
from revisionllm_tpu_torch.ops.norms import rms_norm
from revisionllm_tpu_torch.ops.quant import (
    _is_q8,
    q8_apply,
    q8_apply_multi,
    quantize_activation_rows,
    quantize_int4,
    quantize_int8,
    quantize_rows,
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
    rope_angles_freq,
    rope_tables_interleaved,
    yarn_inv_freq,
    yarn_mscale,
)
from revisionllm_tpu_torch.parallel import comm
from revisionllm_tpu_torch.parallel.sharding import COLUMN_PARALLEL, ROW_PARALLEL, local_config
from revisionllm_tpu_torch.utils import spans
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
    if cfg.latent_attention:
        return _init_mla_params(cfg, gen, dtype, device, quantize, quantize_lm_head)
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


def _prompt_attention(q, k, v, kv_lens, trainable, prefix=None):
    """A prompt's causal attention over its own k/v: K2 on the card, the
    row-4 kernels when training. With `prefix` (pk, pv) [1, P, KH, hd]
    (a P-tuning prefix, or the shared prefix's k/v) every row's queries
    also see all P positions, un-roped: row 6 on the card (the prefix in
    q's type), its plain version on the CPU; when training, the plain lse
    pieces and their merge, which autograd differentiates into the prefix
    (JAX's use_pallas=False branch, llama.py:208-215)."""
    if prefix is None:
        if trainable:
            return trainable_attention(q, k, v, causal=True, kv_lens=kv_lens)
        return attention(q, k, v, causal=True, kv_lens=kv_lens)
    pk, pv = prefix
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


def _dense_layer(cfg, lp, x, rope, attend, lora_lp=None, lora_scale=0.0, mesh=None):
    """The one dense layer, over x [B, T, D] (lp: layer_params' views): RMSNorm,
    q/k/v (one q8_apply_multi, or LoRA's), ChatGLM2's biases, rope, the
    attention, o_proj, the residual add; RMSNorm, `_mlp_block`, the
    residual add. Only the attention varies: `attend(q, k, v)` takes the
    roped q [B, T, H, hd] and k, v [B, T, KH, hd] and returns B * T * H * hd
    values in x's type. Returns (x after the layer, k, v)."""
    B, T, _ = x.shape
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = comm.copy_to_tensor(rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps), mesh)
    if lora_lp is None:
        qm, km, vm = q8_apply_multi(h, (lp["q_proj"], lp["k_proj"], lp["v_proj"]))
    else:
        qm, km, vm = (_lora_apply(h, lp[n], lora_lp.get(n), lora_scale)
                      for n in ("q_proj", "k_proj", "v_proj"))
    q, k, v = _qkv_bias(cfg, lp, qm.reshape(B, T, H, hd), km.reshape(B, T, KH, hd),
                        vm.reshape(B, T, KH, hd))
    q = apply_rope_tables(q, *rope)
    k = apply_rope_tables(k, *rope)
    o = attend(q, k, v).reshape(B, T, H * hd)
    lo = None if lora_lp is None else lora_lp.get("o_proj")
    x = x + _row_parallel(o, lp["o_proj"], lo, lora_scale, mesh)
    del qm, km, vm, q, o  # freed before the MLP, whose intermediates set the peak
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
    return x + _mlp_block(lp, h, lora_lp, lora_scale, mesh), k, v


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
    kv_out: Optional[Params] = None,
):
    """Full-sequence forward. embeds [B, T, D], positions [B, T]; kv_lens
    [B] masks each row's keys past its length.

    Returns the final hidden [B, T, D]; with return_kv=True also the prompt
    cache of `prompt_cache_layout` over P + T positions (P = 0 without a
    prefix), written layer by layer as each layer ends: {"k", "v"}
    [L, B, P + T, KH, hd], int8 with per-(position, head) scales
    {"k_scale", "v_scale"} under kv_quant, so a full-precision cache never
    exists. kv_slab_slots=G (with kv_quant) writes row 10's unified serving
    slab {"kv", "kvsc"} with G generation slots instead (and returns it
    with or without return_kv). kv_out: tensors of that layout over more
    positions (a decode graph set's buffers), written at [0, P + T) in
    place of new ones; the returned cache is their views.

    prefix_kv: a P-tuning prefix (pk, pv) [L, 1, P, KH, hd]
    (models.prefix.prefix_kv), attended un-roped by every query of every
    layer; positions are not shifted. The cache holds it at [0, P), in
    embeds' type, broadcast over the rows, and the tokens at [P, P + T).

    Training: `lora` (models/lora.py tree) adds scale * x A B to every
    adapted matmul; trainable=True takes the differentiable attention
    (row-4 kernels on the card); remat=True checkpoints each layer, which is
    exact because the layers draw no random numbers.

    mesh: params are a rank's shards (module docstring); the prefix is cut
    to this rank's kv heads and the cache holds them."""
    if remat and return_kv:
        raise ValueError("remat is for training; it returns no cache")
    if cfg.latent_attention:
        _refuse_mla(mesh=mesh, prefix=prefix_kv is not None, slab=kv_slab_slots is not None,
                    training=trainable or remat or lora is not None)
        hidden, cache = _mla_forward(cfg, params, embeds, positions, kv_out)
        return (hidden, cache) if return_kv else hidden
    mesh = model_mesh(mesh)
    cfg = local_config(cfg, mesh)
    prefix_kv = _local_prefix(prefix_kv, mesh)
    cache = None
    if return_kv or kv_slab_slots is not None:
        assert kv_slab_slots is None or kv_quant, "kv_slab_slots requires kv_quant=True"
        B, T, _ = embeds.shape
        P = 0 if prefix_kv is None else prefix_kv[0].shape[2]
        cache = new_prompt_cache(cfg, B, P + T, kv_quant, embeds.dtype, embeds.device, kv_out,
                                 kv_slab_slots)
    hidden = _dense_forward(cfg, params, embeds, positions, kv_lens, prefix_kv, cache, mesh,
                            lora, lora_scale, trainable, remat)
    return hidden if cache is None else (hidden, cache)


def _dense_forward(cfg, params, x, positions, kv_lens, prefix, cache, mesh, lora=None,
                   lora_scale=0.0, trainable=False, remat=False):
    """The dense layers and the final norm over x [B, T, D] for a rank's
    local cfg: each layer `_dense_layer` with the prompt's attention
    (`_prompt_attention`, behind `prefix` (pk, pv) [L, 1, P, KH, hd] of
    this rank's kv heads when given). `cache`, when given, gets the prefix
    at positions [0, P) and each layer's k/v at [P, P + T) as the layer
    ends (`_write_prompt_kv`). Returns the final hidden [B, T, D]."""
    rope = rope_for(cfg, positions)
    P = 0 if prefix is None else prefix[0].shape[2]
    if P and cache is not None:  # all layers' prefix in one write, not one a layer
        _write_prompt_kv(cache, slice(None), 0, *(t.to(x.dtype) for t in prefix))
    for i in range(cfg.num_layers):
        lora_lp = _local_lora(lora_layer_params(lora, i), mesh)
        pkv = None if prefix is None else (prefix[0][i], prefix[1][i])

        def layer(x, pkv, i=i, lora_lp=lora_lp):
            attend = functools.partial(_prompt_attention, kv_lens=kv_lens, trainable=trainable,
                                       prefix=pkv)
            return _dense_layer(cfg, layer_params(params, i, mesh), x, rope, attend, lora_lp,
                                lora_scale, mesh)

        if remat:
            # the layer's fsdp gather runs inside the checkpoint, so the
            # gathered weights are not kept for the backward
            x = checkpoint(layer, x, pkv, use_reentrant=False)[0]
            continue
        x, k, v = layer(x, pkv)
        if cache is not None:
            _write_prompt_kv(cache, i, P, k, v)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


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


def _last_logits(params: Params, hidden: torch.Tensor, lens: Optional[torch.Tensor],
                 mesh) -> torch.Tensor:
    """The f32 logits at each row's last position of hidden [B, T, D]:
    position lens - 1 (0 for an empty row), or T - 1 without lens."""
    if lens is None:
        last = hidden[:, -1]
    else:
        idx = (lens.long() - 1).clamp(min=0)
        last = hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]
    return logits_from_hidden(params, last, mesh)


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
    kv_out: Optional[Params] = None,
) -> Tuple[torch.Tensor, Params]:
    """Prefill: (f32 logits at each row's last position [B, V], the
    read-only prompt cache forward_hidden writes, into `kv_out` when given).
    kv_slab_slots=G (with kv_quant) returns row 10's unified serving slab
    {"kv", "kvsc"} with G generation slots (s0 = T) instead of the split
    cache.

    prefix_kv: a P-tuning prefix (pk, pv) [L, 1, P, KH, hd], attended in
    the prefill and held at the cache's positions [0, P), so the cache is
    [L, B, P + T, KH, hd]; decode then masks with mask_lens = kv_lens + P
    and keeps the rope positions on kv_lens (decode_step_split). The serve
    slab takes no prefix (JAX's llama.py:528)."""
    if prefix_kv is not None and kv_slab_slots is not None:
        raise ValueError("P-tuning prefix is not supported with the serve slab")
    hidden, cache = forward_hidden(
        cfg, params, embeds, positions, kv_lens, return_kv=True, kv_quant=kv_quant,
        kv_slab_slots=kv_slab_slots, prefix_kv=prefix_kv, mesh=mesh, kv_out=kv_out,
    )
    return _last_logits(params, hidden, kv_lens, mesh), cache


def prefill_shared_prefix(
    cfg: LlamaConfig,
    params: Params,
    embeds: torch.Tensor,
    positions: torch.Tensor,
    prefix_len: int,
    kv_lens: Optional[torch.Tensor] = None,
    kv_quant: bool = False,
    mesh=None,
    kv_out: Optional[Params] = None,
) -> Tuple[torch.Tensor, Params]:
    """Prefill where every row shares its first P = `prefix_len` embeddings
    (the engine's window batches share their prompt up to the video block).

    The prefix runs once at B = 1; the rest [B, T - P] then runs the same
    layers with that pass's k/v of each layer as the attended prefix (row 6
    on the card), as a P-tuning prefix is attended, at its own positions.
    Returns what `prefill_kv` returns: logits at each row's last position
    and the prompt cache [L, B, T, KH, hd], the prefix broadcast at [0, P)
    and the rest at [P, T) (int8 with its scales under kv_quant, written
    layer by layer), into `kv_out` when given."""
    if cfg.latent_attention:
        _refuse_mla(what="the shared-prefix prefill")
    mesh = model_mesh(mesh)
    B, T, _ = embeds.shape
    P = prefix_len
    _, shared = forward_hidden(cfg, params, embeds[:1, :P], positions[:1, :P], return_kv=True,
                               mesh=mesh)
    cfg = local_config(cfg, mesh)
    rest_lens = None if kv_lens is None else (kv_lens.to(torch.int32) - P).clamp(min=0)
    cache = new_prompt_cache(cfg, B, T, kv_quant, embeds.dtype, embeds.device, kv_out)
    hidden = _dense_forward(cfg, params, embeds[:, P:], positions[:, P:], rest_lens,
                            (shared["k"], shared["v"]), cache, mesh)
    return _last_logits(params, hidden, rest_lens, mesh), cache


def prompt_cache_layout(cfg: LlamaConfig, batch: int, length: int, kv_quant: bool,
                        dtype, slab_slots: Optional[int] = None
                        ) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """The prompt cache's tensors as {name: (shape, dtype)}: {"k", "v"}
    [L, B, S, KH, hd] in `dtype`, or int8 with {"k_scale", "v_scale"}
    [L, B, S, KH] f32 under kv_quant; with slab_slots=G row 10's unified
    int8 slab {"kv" [L, B, 2, KH, Sp, hd], "kvsc" [L, B, 2, KH, Sp] f32},
    Sp = round_up(S + G, 128); for MLA {"latent"} [L, B, S, C + R] in
    `dtype` under either KV8 setting."""
    L = cfg.num_layers
    if cfg.latent_attention:
        return {"latent": ((L, batch, length, cfg.kv_lora_rank + cfg.qk_rope_head_dim), dtype)}
    if slab_slots is not None:
        Sp = -(-(length + slab_slots) // 128) * 128
        shape = (L, batch, 2, cfg.num_kv_heads, Sp, cfg.head_dim)
        return {"kv": (shape, torch.int8), "kvsc": (shape[:-1], torch.float32)}
    shape = (L, batch, length, cfg.num_kv_heads, cfg.head_dim)
    if not kv_quant:
        return {"k": (shape, dtype), "v": (shape, dtype)}
    return {"k": (shape, torch.int8), "v": (shape, torch.int8),
            "k_scale": (shape[:-1], torch.float32), "v_scale": (shape[:-1], torch.float32)}


def new_prompt_cache(cfg: LlamaConfig, batch: int, length: int, kv_quant: bool, dtype, device,
                     kv_out: Optional[Params] = None, slab_slots: Optional[int] = None) -> Params:
    """The prompt cache of `length` positions for a prefill to fill: new
    tensors of `prompt_cache_layout` (the slab zeroed: its decode reads
    past the prompt), or the views at positions [0, length) of `kv_out`,
    tensors of the split layout over more positions (a decode graph set's
    static buffers, models/generation.py)."""
    if kv_out is not None:
        return {name: t[:, :, :length] for name, t in kv_out.items()}
    new = torch.empty if slab_slots is None else torch.zeros
    return {name: new(shape, dtype=dt, device=device)
            for name, (shape, dt) in prompt_cache_layout(cfg, batch, length, kv_quant, dtype,
                                                         slab_slots).items()}


def _write_prompt_kv(cache: Params, i, start: int, k: torch.Tensor, v: torch.Tensor) -> None:
    """The prompt cache's one writer: layer i's k and v [B, n, KH, hd] (one
    row is broadcast over the B) at positions [start, start + n), in the
    cache's layout: {"k", "v"} in their type; int8 rows (quantize_rows,
    per (position, head) scales) with {"k_scale", "v_scale"}; or row 10's
    unified slab {"kv", "kvsc"}, heads before positions. i may be a slice
    over the layers (k, v [L, B or 1, n, KH, hd])."""
    pos = slice(start, start + k.shape[-3])
    for j, (name, t) in enumerate((("k", k), ("v", v))):
        if "kv" in cache:
            tq, ts = quantize_rows(t)
            cache["kv"][i, :, j, :, pos] = tq.transpose(-3, -2)
            cache["kvsc"][i, :, j, :, pos] = ts[..., 0].transpose(-2, -1)
        elif f"{name}_scale" in cache:
            tq, ts = quantize_rows(t)
            _put_rows(cache[name][i, :, pos], tq)
            cache[f"{name}_scale"][i, :, pos] = ts[..., 0]
        else:
            cache[name][i, :, pos] = t


def _put_rows(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst[...] = src for int8 cache rows of head_dim (a multiple of 8),
    moved as 8-byte words: a copy into a strided view (a graph set's padded
    buffers) goes element by element, and an element of a byte is about
    2.7x slower on an H100 (DeepSeek-LLM-7B's cache of 64 x 308 positions,
    30 layers: 11.0 against 4.1 ms)."""
    dst.view(torch.int64).copy_(src.view(torch.int64))


def init_gen_cache(cfg: LlamaConfig, batch: int, slots: int, dtype, device) -> Params:
    """Zeroed generated-token cache {"k", "v"} [L, B, G, KH, hd]; for MLA
    {"latent"} [L, B, G, kv_lora_rank + qk_rope_head_dim]."""
    if cfg.latent_attention:
        width = cfg.kv_lora_rank + cfg.qk_rope_head_dim
        return {"latent": torch.zeros((cfg.num_layers, batch, slots, width), dtype=dtype,
                                      device=device)}
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
    """One decode step with the split KV layout: token_embeds [B, 1, D] at
    rope positions prompt_lens + step through every `_dense_layer`, whose
    attention writes this step's k/v into gen_cache [L, B, G, KH, hd] at
    slot `step` IN PLACE (JAX returns an updated copy; the returned dict is
    the same tensors) and is then one decode_attention call (K3) over
    [the read-only prompt_kv [L, B, S, KH, hd] | the generated slots].
    mask_lens: valid prompt positions per row (default prompt_lens;
    prompt_lens + P over a cache that holds a P-tuning prefix, whose rope
    positions stay on prompt_lens).
    Returns (logits [B, V] f32, gen_cache).

    MLA (cfg.latent_attention): prompt_kv {"latent"} [L, B, S, C + R]
    and gen_cache {"latent"} [L, B, G, C + R] (`_mla_decode_layer`)."""
    if cfg.latent_attention:
        _refuse_mla(mesh=mesh)
        return _mla_decode_step(cfg, params, prompt_kv, prompt_lens, gen_cache, step,
                                token_embeds, prompt_lens if mask_lens is None else mask_lens)
    mesh = model_mesh(mesh)
    cfg = local_config(cfg, mesh)
    B, dtype = token_embeds.shape[0], token_embeds.dtype
    KH, hd = cfg.num_kv_heads, cfg.head_dim
    rope = rope_for(cfg, (prompt_lens.long() + step)[:, None])
    mask_lens = prompt_lens if mask_lens is None else mask_lens
    scales = "k_scale" in prompt_kv

    def attend(i, q, k, v):
        gk, gv = gen_cache["k"][i], gen_cache["v"][i]
        gk[:, step] = k[:, 0].to(gk.dtype)
        gv[:, step] = v[:, 0].to(gv.dtype)
        return decode_attention(
            q.reshape(B, KH, -1, hd), prompt_kv["k"][i], prompt_kv["v"][i],
            prompt_kv["k_scale"][i] if scales else None,
            prompt_kv["v_scale"][i] if scales else None,
            gk, gv, mask_lens, step,
        ).to(dtype)

    x = token_embeds
    for i in range(cfg.num_layers):
        x = _dense_layer(cfg, layer_params(params, i, mesh), x, rope,
                         functools.partial(attend, i), mesh=mesh)[0]
    hidden = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return logits_from_hidden(params, hidden[:, 0], mesh), gen_cache


def quantize_prompt_kv(prompt_kv: Params) -> Params:
    """Int8 prompt KV: per-(layer, batch, position, head) absmax over hd."""
    k = prompt_kv["k"]
    out = {}
    for name in ("k", "v"):
        out[name] = torch.empty(k.shape, dtype=torch.int8, device=k.device)
        out[f"{name}_scale"] = torch.empty(k.shape[:-1], dtype=torch.float32, device=k.device)
    _write_prompt_kv(out, slice(None), 0, k, prompt_kv["v"])
    return out


# ---------------------------------------------------------------------------
# DeepSeek-V2: multi-head latent attention and DeepSeekMoE
# ---------------------------------------------------------------------------


def _refuse_mla(mesh=None, prefix=False, slab=False, training=False, what=None):
    """ValueError for the paths DeepSeek-V2's layers do not take."""
    if what is None:
        if model_mesh(mesh) is not None:
            what = "a mesh that splits the weights (tp or fsdp)"
        elif prefix:
            what = "a P-tuning prefix"
        elif slab:
            what = "the serve slab (row 10)"
        elif training:
            what = "training (LoRA, the differentiable attention, remat)"
        elif _fused_mlp_enabled():
            what = "REVISIONLLM_FUSED_MLP=1 (row 8)"
    if what is not None:
        raise ValueError(f"DeepSeek-V2 (MLA and DeepSeekMoE) does not run with {what}")


def _init_mla_params(cfg, gen, dtype, device, quantize, quantize_lm_head) -> Params:
    """init_params for DeepseekV2Config: scaled normal matrices, drawn one
    at a time and kept int8 per output channel (quantize) or in `dtype`;
    the router f32 [D, E]; norms 1. The serving layouts are added by
    `add_mla_layouts`."""
    fmt = {False: None, True: "int8", "int8": "int8"}.get(quantize)
    if quantize not in (False, True, "int8"):
        raise ValueError("DeepSeek-V2 serves int8 or dense weights")
    D, H, C, R = cfg.hidden_size, cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    dn, dv, E = cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.n_routed_experts
    L, Ld, Lm = cfg.num_layers, cfg.first_k_dense_replace, cfg.num_moe_layers
    Fm, Fs = cfg.moe_intermediate_size, cfg.moe_intermediate_size * cfg.n_shared_experts

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * std

    def stack(lead, din, dout, fmt=fmt):
        """[*lead, din, dout] matrices, drawn one [din, dout] at a time."""
        n = 1
        for d in lead:
            n *= d
        if fmt:
            out = {"q8": torch.empty((n, din, dout), dtype=torch.int8, device=device),
                   "scale": torch.empty((n, dout), dtype=torch.float32, device=device)}
        else:
            out = torch.empty((n, din, dout), dtype=dtype, device=device)
        for i in range(n):
            w = normal((din, dout), din ** -0.5)
            if fmt:
                out["q8"][i], out["scale"][i] = quantize_int8(w)
            else:
                out[i] = w.to(dtype)
        if fmt:
            return {k: v.reshape(*lead, *v.shape[1:]) for k, v in out.items()}
        return out.reshape(*lead, din, dout)

    ones = lambda *shape: torch.ones(shape, dtype=dtype, device=device)  # noqa: E731
    layers = {
        "attn_norm": ones(L, D), "mlp_norm": ones(L, D), "kv_a_norm": ones(L, C),
        "q_proj": stack((L,), D, H * (dn + R)),
        "kv_a_proj": stack((L,), D, C + R),
        "kv_b_proj": stack((L,), C, H * (dn + dv)),
        "o_proj": stack((L,), H * dv, D),
    }
    params = {
        "embed": normal((cfg.vocab_size, D), 0.02).to(dtype),
        "layers": layers,
        "dense": {"gate_proj": stack((Ld,), D, cfg.intermediate_size),
                  "up_proj": stack((Ld,), D, cfg.intermediate_size),
                  "down_proj": stack((Ld,), cfg.intermediate_size, D)},
        "moe": {
            "router": normal((Lm, D, E), D ** -0.5),
            "experts": {"gu": stack((Lm, E), D, 2 * Fm), "down": stack((Lm, E), Fm, D)},
            "shared_gate": stack((Lm,), D, Fs), "shared_up": stack((Lm,), D, Fs),
            "shared_down": stack((Lm,), Fs, D),
        },
        "final_norm": ones(D),
        "lm_head": stack((), D, cfg.vocab_size, fmt if quantize_lm_head else None),
    }
    return add_mla_layouts(cfg, params)


def add_mla_layouts(cfg, params: Params) -> Params:
    """The serving layouts a DeepSeek-V2 tree needs beside its matrices, made
    once (in place; returns the tree): the absorbed decode's W_uk [L, H, dn,
    C] and W_uv [L, H, C, dv] from kv_b_proj's int8 values, in the
    embedding's type (bf16 when served), and each
    int8 expert matrix again K-major ("gu_t" [Lm, E, 2F, D], "down_t" [Lm,
    E, D, F]) for the grouped W8A8 GEMM, whose int8 wgmma reads both
    operands K-major."""
    H, C, dn, dv = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.v_head_dim
    lay = params["layers"]
    kvb = lay["kv_b_proj"]
    dtype = params["embed"].dtype
    if _is_q8(kvb):
        w = (kvb["q8"].float() * kvb["scale"][:, None, :]).to(dtype)
    else:
        w = kvb.to(dtype)
    w = w.reshape(w.shape[0], C, H, dn + dv)
    lay["w_uk"] = w[..., :dn].permute(0, 2, 3, 1).contiguous()
    lay["w_uv"] = w[..., dn:].permute(0, 2, 1, 3).contiguous()
    del w
    ex = params["moe"]["experts"]
    for name in ("gu", "down"):
        m = ex[name]
        ex[f"{name}_t"] = (m["q8"] if _is_q8(m) else m).transpose(-1, -2).contiguous()
    return params


def mla_rope(cfg, positions: torch.Tensor):
    """The YaRN rotary tables of `positions` [..., T] for the rope part of
    each head (qk_rope_head_dim), in interleaved pairs, the cos and sin
    times mscale(mscale) / mscale(mscale_all_dim) (1 for V2-Lite)."""
    f = cfg.rope_scaling_factor
    m = yarn_mscale(f, cfg.yarn_mscale) / yarn_mscale(f, cfg.yarn_mscale_all_dim)
    cos, sin = rope_angles_freq(positions, _mla_inv_freq(cfg, positions.device), m)
    return (*rope_tables_interleaved(cos, sin, cfg.qk_rope_head_dim), True)


@functools.lru_cache(maxsize=None)
def _mla_inv_freq(cfg, device) -> torch.Tensor:
    """YaRN's inverse frequencies of cfg's rope part, made once a device."""
    return yarn_inv_freq(cfg.qk_rope_head_dim, cfg.rope_theta, cfg.rope_scaling_factor,
                         cfg.rope_original_max_position, cfg.yarn_beta_fast, cfg.yarn_beta_slow,
                         device=device)


def mla_softmax_scale(cfg) -> float:
    """qk_head_dim^-0.5, times mscale(mscale_all_dim)^2 under YaRN."""
    m = yarn_mscale(cfg.rope_scaling_factor, cfg.yarn_mscale_all_dim)
    return cfg.qk_head_dim ** -0.5 * m * m


def _mla_latent(cfg, lp, h, rope):
    """h [B, T, D] -> (q_nope [B, T, H, dn], q_pe [B, T, H, R] rotated, the
    normed compressed kv c [B, T, C], the latent [B, T, C + R]: c and the
    rotated shared k_pe) through q_proj and kv_a_proj, which share one
    activation quantization in the W8A8 prefill; q_pe and k_pe rotate in
    one pass."""
    B, T, _ = h.shape
    H, C, R, dn = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.qk_nope_head_dim
    q, kva = q8_apply_multi(h, (lp["q_proj"], lp["kv_a_proj"]))
    q = q.reshape(B, T, H, dn + R)
    pe = apply_rope_tables(torch.cat([q[..., dn:], kva[..., None, C:]], dim=2), *rope)
    c = rms_norm(kva[..., :C], lp["kv_a_norm"], cfg.rms_norm_eps)
    return q[..., :dn], pe[:, :, :H], c, torch.cat([c, pe[:, :, H]], dim=-1)


def mla_prefill_attention(q, k, v, scale: float) -> torch.Tensor:
    """Causal attention of q, k [B, T, H, dq] and v [B, T, H, dv] as
    modeling_deepseek.py computes it: products in q's type, the scores
    scaled, softmax in f32 and cast back. Plain PyTorch products (no fused
    attention operator)."""
    T = q.shape[1]
    s = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1)) * scale     # [B, H, T, T]
    mask = torch.ones((T, T), dtype=torch.bool, device=q.device).triu_(1)
    s = s.masked_fill_(mask, float("-inf"))
    p = torch.softmax(s, dim=-1, dtype=torch.float32).to(q.dtype)
    return torch.matmul(p, v.transpose(1, 2)).transpose(1, 2)                # [B, T, H, dv]


def _mla_prefill_layer(cfg, lp, h, rope):
    """MLA decompressed: the latent, k_nope and v from kv_b_proj, attention
    over q/k heads of dn + R and v heads of dv, o_proj. Returns (the
    attention's output [B, T, D], the latent [B, T, C + R])."""
    B, T, _ = h.shape
    H, C, dn, dv = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.v_head_dim
    q_nope, q_pe, c, latent = _mla_latent(cfg, lp, h, rope)
    kv = q8_apply(c, lp["kv_b_proj"]).reshape(B, T, H, dn + dv)
    k_pe = latent[:, :, None, C:].expand(B, T, H, cfg.qk_rope_head_dim)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([kv[..., :dn], k_pe], dim=-1)
    o = mla_prefill_attention(q, k, kv[..., dn:], mla_softmax_scale(cfg))
    return q8_apply(o.reshape(B, T, H * dv), lp["o_proj"]), latent


def tree_at(tree: Params, i: int) -> Params:
    """Views of entry i of a tree stacked on a leading axis, at any depth."""
    return {k: tree_at(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _mla_layer_pieces(cfg, params, i: int, st: Dict[str, Any], attention):
    """Layer i as two pieces (span name or None, layer, fn) that read and
    write the residual stream st["x"] [B, T, D]: its attention
    (`attention(i, lp, h)` on the normed stream) and its MLP, dense for the
    first first_k_dense_replace layers and DeepSeekMoE (ops/moe.py) after
    them, whose fn returns its counters (MOE.moe_counters' arguments); each
    piece's norm and residual add are inside it."""
    lp = layer_params(params, i)
    k, eps = cfg.first_k_dense_replace, cfg.rms_norm_eps

    def mla():
        st["x"] = st["x"] + attention(i, lp, rms_norm(st["x"], lp["attn_norm"], eps))

    def mlp():
        h = rms_norm(st["x"], lp["mlp_norm"], eps)
        if i < k:
            st["x"] = st["x"] + _mlp_block(tree_at(params["dense"], i), h)
            return None
        y, counts = MOE.moe_block(cfg, tree_at(params["moe"], i - k), h)
        st["x"] = st["x"] + y
        return h.numel() // h.shape[-1], cfg.num_experts_per_tok, counts

    return [("model.mla", i, mla), ("model.moe" if i >= k else None, i, mlp)]


def run_mla_piece(name, layer, fn, device):
    """One piece under its span (`device` for the span's events), the MoE
    counters noted while spans record. Returns what fn returned."""
    with spans.span(name, device=device, layer=layer) if name else contextlib.nullcontext():
        out = fn()
        note_moe(out)
    return out


def note_moe(counters) -> None:
    """A MoE piece's counters onto the open span `model.moe` (spans on)."""
    if counters is not None and spans.recording():
        spans.note(**MOE.moe_counters(*counters))


def _mla_forward(cfg, params, embeds, positions, kv_out=None):
    """The MLA model over embeds [B, T, D]: (final hidden [B, T, D], the
    latent cache {"latent" [L, B, T, C + R]} in embeds' type, written into
    `kv_out` when given)."""
    B, T, _ = embeds.shape
    rope = mla_rope(cfg, positions)
    cache = new_prompt_cache(cfg, B, T, False, embeds.dtype, embeds.device, kv_out)

    def attention(i, lp, h):
        attn, cache["latent"][i] = _mla_prefill_layer(cfg, lp, h, rope)
        return attn

    st = {"x": embeds}
    for i in range(cfg.num_layers):
        for piece in _mla_layer_pieces(cfg, params, i, st, attention):
            run_mla_piece(*piece, embeds.device)
    return rms_norm(st["x"], params["final_norm"], cfg.rms_norm_eps), cache


def _mla_decode_layer(cfg, lp, h, rope, prompt_lat, gen_lat, mask, step: int):
    """MLA absorbed for one token a row, h [B, 1, D]: q_nope through W_uk
    into the latent, scores q_lat . c + q_pe . k_pe over the read-only prompt
    latent [B, S, C + R] and the generated one [B, G, C + R] (slots <= step;
    this step's written first, in place), scaled, plus mask [B, 1, S + step
    + 1] (-inf past each row's prompt), softmax in f32, the weighted latent
    through W_uv, o_proj."""
    B = h.shape[0]
    C, scale = cfg.kv_lora_rank, mla_softmax_scale(cfg)
    q_nope, q_pe, _, latent = _mla_latent(cfg, lp, h, rope)
    gen_lat[:, step] = latent[:, 0]
    q_lat = torch.bmm(q_nope[:, 0].transpose(0, 1), lp["w_uk"])               # [H, B, C]
    qf = torch.cat([q_lat.transpose(0, 1), q_pe[:, 0]], dim=-1).float()      # [B, H, C + R]
    S = prompt_lat.shape[1]
    pl, gl = prompt_lat.float(), gen_lat[:, : step + 1].float()
    s = torch.cat([torch.baddbmm(mask[..., :S], qf, pl.transpose(1, 2), alpha=scale),
                   torch.baddbmm(mask[..., S:], qf, gl.transpose(1, 2), alpha=scale)], dim=-1)
    p = torch.softmax(s, dim=-1)
    o_lat = torch.baddbmm(torch.bmm(p[..., S:], gl[..., :C]), p[..., :S], pl[..., :C])
    o = torch.bmm(o_lat.to(h.dtype).transpose(0, 1), lp["w_uv"])             # [H, B, dv]
    return q8_apply(o.transpose(0, 1).reshape(B, 1, -1), lp["o_proj"])


def mla_decode_pieces(cfg, params, prompt_kv, prompt_lens, gen_cache, step, token_embeds,
                      mask_lens):
    """One MLA decode step as pieces (span name or None, layer, fn) run in
    order: the rotary tables and the mask, two a layer
    (`_mla_layer_pieces`), the final norm and the logits. They share the
    returned dict, whose "logits" [B, V] f32 the last piece writes.
    `_mla_decode_step` runs them one after another; models/generation.py
    captures each as a CUDA graph and replays them under the same spans."""
    st: Dict[str, Any] = {"x": token_embeds}
    S = prompt_kv["latent"].shape[2]

    def prologue():
        st["rope"] = mla_rope(cfg, (prompt_lens.long() + step)[:, None])
        past = torch.arange(S + step + 1, device=token_embeds.device)[None] \
            >= mask_lens.long()[:, None]
        past[:, S:] = False
        st["mask"] = torch.zeros(past.shape, device=past.device).masked_fill_(
            past, float("-inf"))[:, None]

    def attention(i, lp, h):
        return _mla_decode_layer(cfg, lp, h, st["rope"], prompt_kv["latent"][i],
                                 gen_cache["latent"][i], st["mask"], step)

    def head():
        hidden = rms_norm(st["x"], params["final_norm"], cfg.rms_norm_eps)
        st["logits"] = logits_from_hidden(params, hidden[:, 0])

    pieces = [(None, None, prologue)]
    for i in range(cfg.num_layers):
        pieces += _mla_layer_pieces(cfg, params, i, st, attention)
    return pieces + [(None, None, head)], st


def _mla_decode_step(cfg, params, prompt_kv, prompt_lens, gen_cache, step, token_embeds,
                     mask_lens):
    pieces, st = mla_decode_pieces(cfg, params, prompt_kv, prompt_lens, gen_cache, step,
                                   token_embeds, mask_lens)
    for piece in pieces:
        run_mla_piece(*piece, token_embeds.device)
    return st["logits"], gen_cache
