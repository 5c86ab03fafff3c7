"""Parameter sharding rules (FSDP + tensor parallel), and each rank's shards.

Counterpart of revisionllm_tpu/parallel/sharding.py. The spec trees are the
JAX package's, with a PartitionSpec written as a tuple (one axis name or
None a dimension; () replicates the whole leaf). Every large matrix is
sharded over the `fsdp` axis and over the `tensor` axis in Megatron's
orientation:

  column-parallel (shard output dim): q/k/v/gate/up projections, lm_head
  row-parallel   (shard input  dim): o_proj, down_proj

Layer matrices are stacked [L, din, dout]; the layer axis is never sharded.
`shard_params` keeps only this rank's block of every leaf; the model
(models/llama.py, given the mesh) gathers a layer's fsdp shards just before
it runs and sums the row-parallel outputs over `tensor`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

COLUMN_PARALLEL = {"q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"}
ROW_PARALLEL = {"o_proj", "down_proj"}
Q4_GROUP = 128  # ops.quant.Q4_GROUP: int4 weights shard K in whole groups


def _quant(w) -> Optional[str]:
    if isinstance(w, dict):
        return "q8" if "q8" in w else "q4" if "q4" in w else None
    return None


def llama_param_specs(params: Dict[str, Any]) -> Dict[str, Any]:
    """The spec tree of a models/llama.init_params tree (JAX's :26-56).

    Quantized {'q8','scale'} leaves (int8 frozen-base training / serving)
    get the matrix spec on values and the output-channel sharding on the
    per-channel scale row. Any other leaf of `layers` (the norms, ChatGLM2's
    biases) is replicated, as JAX's (None, None); an int4 dict takes the
    matrix spec whole, on both of its leaves."""
    layer_specs = {}
    for name, w in params["layers"].items():
        if name in COLUMN_PARALLEL:
            spec = (None, "fsdp", "tensor")
        elif name in ROW_PARALLEL:
            spec = (None, "tensor", "fsdp")
        else:
            layer_specs[name] = (None, None)
            continue
        if _quant(w) == "q8":
            layer_specs[name] = {"q8": spec, "scale": (None, spec[2])}
        else:
            layer_specs[name] = spec
    lm = params.get("lm_head")
    lm_spec = ({"q8": ("fsdp", "tensor"), "scale": ("tensor",)} if _quant(lm) == "q8"
               else ("fsdp", "tensor"))
    return {
        "embed": ("fsdp", "tensor"),
        "layers": layer_specs,
        "final_norm": (None,),
        "lm_head": lm_spec,
    }


def lora_param_specs(lora: Dict[str, Any]) -> Dict[str, Any]:
    """JAX's LoRA specs (:59-64): only the non-rank dim over fsdp. The
    sharded train step keeps the (small, r 64) LoRA whole on every rank and
    slices it where the base is tensor-split, so nothing places it by these."""
    return {"layers": {name: {"a": (None, "fsdp", None), "b": (None, None, "fsdp")}
                       for name in lora["layers"]}}


def vision_param_specs(vision: Any) -> Any:
    """Adapter params are small (~20M): replicate everything."""
    if isinstance(vision, dict):
        return {k: vision_param_specs(v) for k, v in vision.items()}
    if isinstance(vision, (list, tuple)):
        return type(vision)(vision_param_specs(v) for v in vision)
    return ()


def _leaf_shard(t: torch.Tensor, spec: tuple, mesh, name: str) -> torch.Tensor:
    """This rank's block of `t` under `spec` (a tuple over t's leading dims)."""
    out = t
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        for axis in (axes,) if isinstance(axes, str) else axes:
            n = mesh.axis_size(axis)
            if n == 1:
                continue
            size = out.shape[dim]
            if size % n:
                raise ValueError(f"{name}: dimension {dim} of size {size} does not split "
                                 f"over {axis} {n}")
            b = size // n
            out = out.narrow(dim, mesh.coord(axis) * b, b)
    return out.contiguous()


def _check_int4(name: str, w: Dict[str, torch.Tensor], spec: tuple, mesh) -> None:
    """Int4 weights shard K in whole quantization groups: a rank's K rows
    must be a multiple of Q4_GROUP (row-parallel down_proj at tp 4 has
    11008 / 4 = 2752, which is not)."""
    K = w["q4"].shape[-2] * 2
    for axes in spec[-2:-1]:
        if axes is None:
            continue
        for axis in (axes,) if isinstance(axes, str) else axes:
            n = mesh.axis_size(axis)
            if n > 1 and (K % n or (K // n) % Q4_GROUP):
                raise ValueError(
                    f"{name}: int4 weights shard K in whole groups of {Q4_GROUP}, but K "
                    f"{K} over {axis} {n} leaves {K / n:g} rows a rank, not a multiple of "
                    f"{Q4_GROUP}")


def shard_params(mesh, params: Any, spec_tree: Any, name: str = "") -> Any:
    """This rank's local shards of `params` under `spec_tree` (a tuple
    applies to every leaf below it, as a JAX spec prefix does). With a
    one-rank mesh or None every leaf is returned as is."""
    if mesh is None or mesh.size == 1:
        return params
    if isinstance(spec_tree, tuple) or spec_tree is None:
        spec = spec_tree or ()
        if _quant(params) == "q4":
            _check_int4(name, params, spec, mesh)
        if isinstance(params, dict):
            return {k: shard_params(mesh, v, spec, f"{name}.{k}") for k, v in params.items()}
        if isinstance(params, (list, tuple)):
            return type(params)(shard_params(mesh, v, spec, name) for v in params)
        if isinstance(params, torch.Tensor):
            return _leaf_shard(params, spec, mesh, name)
        return params
    return {k: shard_params(mesh, params[k], spec_tree[k], f"{name}.{k}".lstrip("."))
            for k in params}


def local_config(cfg, mesh):
    """The geometry one rank computes under tensor parallelism: H / tp
    query heads, KH / tp kv heads and an F / tp MLP; `cfg` itself without
    it. Raises ValueError when the heads do not split."""
    tp = 1 if mesh is None else mesh.shape["tensor"]
    if tp == 1:
        return cfg
    H, KH, F = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size
    if H % tp or KH % tp or F % tp:
        raise ValueError(f"tensor parallelism {tp} needs heads ({H}), kv heads ({KH}) and "
                         f"the MLP width ({F}) divisible by it")
    return dataclasses.replace(cfg, num_heads=H // tp, num_kv_heads=KH // tp,
                               intermediate_size=F // tp)
