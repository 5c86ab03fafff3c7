"""Multi-rank serving: the generate program over a mesh.

Counterpart of revisionllm_tpu/parallel/serve.py. Weights shard per
parallel/sharding.py (FSDP + Megatron tensor parallelism); the window batch
splits over the (data, fsdp) axes when they divide it and stays whole on
every rank otherwise; the outputs are gathered so that every rank returns
the whole batch. generation.generate runs unchanged on each rank's rows,
with the mesh for the model's own collectives.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from revisionllm_tpu_torch.parallel import sharding as shard_lib
from revisionllm_tpu_torch.parallel.mesh import BatchShard, batch_sharding


def _packed(params: Dict[str, Any]) -> bool:
    lq = params["layers"].get("q_proj")
    return isinstance(lq, dict) and "q8c" in lq


def shard_params_for_inference(mesh, params: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's shards of a serving tree, by JAX's serving specs
    (:21-56): column-parallel matrices (None, fsdp, tensor) with an int8
    scale on tensor, row-parallel ones (None, tensor, fsdp) with the scale
    on fsdp, the embedding and lm_head (fsdp, tensor) with the lm_head's
    scale on tensor, every other leaf whole. A serving-packed tree (row 10)
    stays whole under a data-only mesh and raises under tensor or fsdp
    sharding (one launch holds whole layers)."""
    if mesh is None or mesh.size == 1:
        return params
    split = mesh.shape["tensor"] > 1 or mesh.shape["fsdp"] > 1
    if not split:
        return params
    if _packed(params):
        raise ValueError("a serving-packed tree (row 10) holds whole layers in one launch and "
                         "cannot be split over tensor or fsdp: use a data-only mesh or the "
                         "standard tree")
    return shard_lib.shard_params(mesh, params, shard_lib.llama_param_specs(params))


def gather_outputs(out: Dict[str, torch.Tensor], shard: BatchShard,
                   batch: int) -> Dict[str, torch.Tensor]:
    """Every [B_local, ...] output gathered back to [B, ...] on every rank."""
    return {k: shard.gather(v, batch) for k, v in out.items()}


def make_sharded_generate(cfg, mesh, **generate_kwargs):
    """run(params, embeds, positions, prompt_lens) -> generate's outputs for
    the whole batch on every rank: the rows split over (data, fsdp) when
    they divide, the model's collectives over the mesh, the outputs
    gathered. `params` are this rank's shards (shard_params_for_inference)."""
    from revisionllm_tpu_torch.models import generation

    shard = batch_sharding(mesh)

    def run(params, embeds, positions, prompt_lens):
        B = embeds.shape[0]
        out = generation.generate(
            cfg, params, shard.local(embeds, B), shard.local(positions, B),
            shard.local(prompt_lens, B), mesh=mesh, **generate_kwargs,
        )
        return gather_outputs(out, shard, B)

    return run
