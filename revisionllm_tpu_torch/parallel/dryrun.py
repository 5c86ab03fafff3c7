"""A CPU check of the distributed layer in N gloo ranks.

The role of the JAX package's __graft_entry__.dryrun_multichip: one sharded
train step on its tiny shapes, and one sharded generate held token for token
against the one-process generate, over a (dp, fsdp, tp) mesh that uses every
axis it can:

    python -m revisionllm_tpu_torch.parallel.dryrun [N]     # default 8: 2x2x2

prints `dryrun_multichip ok: mesh 2x2x2, loss ..., sharded-generate token
parity (B, G) exact`, and exits non-zero when a rank fails or a token
differs.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from revisionllm_tpu_torch.config import AdapterConfig, LlamaConfig, LoraConfig, TrainConfig
from revisionllm_tpu_torch.constants import IMAGE_TOKEN_INDEX

CFG = LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=128, num_layers=2,
                  num_heads=4, num_kv_heads=4, head_dim=16, max_position_embeddings=128,
                  dtype="float32")
ADAPTER = AdapterConfig(kind="clip_encoder", d_model=32, num_heads=4, num_layers=2, ffn_dim=64,
                        hidden_size=64, clip_adapter_text=True, hierarchy=True,
                        feature_mode="cls")
TRAIN = TrainConfig(training_stage=2, lora=LoraConfig(r=4, alpha=8), gradient_checkpointing=True,
                    gradient_accumulation=1, per_device_batch_size=1)
GEN_TOKENS = 4


def mesh_shape(n: int):
    """n ranks as (dp, fsdp, tp), every axis used when n allows (JAX's
    factoring)."""
    if n % 4 == 0:
        return n // 4, 2, 2
    if n % 2 == 0:
        return n // 2, 2, 1
    return n, 1, 1


def _inputs(B: int):
    from revisionllm_tpu_torch.models import llama, revisionllm
    from revisionllm_tpu_torch.models.multimodal import build_splice_plan, stack_plans

    base = llama.init_params(CFG, seed=0, device="cpu", dtype=torch.float32)
    vision = revisionllm.init_vision_params(ADAPTER, seed=1, d_in=32, device="cpu")
    V, T, L = 4, 4, 32
    prompt = [1, 10, 11, IMAGE_TOKEN_INDEX, 12, 13, 14]
    labels = [-100, -100, -100, -100, 20, 21, 22]
    plans = stack_plans([build_splice_plan(prompt, V, L, labels=labels) for _ in range(B)])
    rng = np.random.default_rng(0)
    batch = {**{k: torch.as_tensor(v) for k, v in plans.items()},
             "images": torch.as_tensor(rng.normal(size=(B, V, T, 32)), dtype=torch.float32),
             "query_feats": torch.as_tensor(rng.normal(size=(B, 5, 32)), dtype=torch.float32),
             "query_valid": torch.ones((B, 5), dtype=torch.bool)}
    rng_g = np.random.default_rng(7)
    Tg = 6
    gen = (torch.as_tensor(rng_g.normal(size=(B, Tg, CFG.hidden_size)), dtype=torch.float32),
           torch.arange(Tg, dtype=torch.int32).expand(B, Tg),
           torch.full((B,), Tg, dtype=torch.int32))
    return base, vision, batch, gen


def generate_one(B: int) -> torch.Tensor:
    """The one-process generate's tokens on the dryrun's serving inputs."""
    from revisionllm_tpu_torch.models import generation

    base, _, _, (embeds, pos, lens) = _inputs(B)
    return generation.generate(CFG, base, embeds, pos, lens, eos_id=2,
                               max_new_tokens=GEN_TOKENS)["tokens"]


def rank_main(shape, B: int):
    """One rank: a sharded train step, then the sharded generate."""
    from revisionllm_tpu_torch.parallel import mesh as mesh_lib
    from revisionllm_tpu_torch.parallel import serve
    from revisionllm_tpu_torch.parallel import sharding as shard_lib
    from revisionllm_tpu_torch.train import optimizer as opt_lib
    from revisionllm_tpu_torch.train import trainer as trainer_lib

    torch.set_num_threads(1)
    mesh = mesh_lib.create_mesh(*shape)
    base, vision, batch, (embeds, pos, lens) = _inputs(B)
    trainable, frozen = trainer_lib.build_trainable(CFG, TRAIN, vision,
                                                    torch.Generator().manual_seed(2))
    optimizer = opt_lib.AdamW(trainer_lib.tree_leaves(trainable), TRAIN, 100)
    step = trainer_lib.make_sharded_train_step(CFG, ADAPTER, TRAIN, optimizer, mesh)
    sharded = shard_lib.shard_params(mesh, base, shard_lib.llama_param_specs(base))
    metrics = step(trainable, frozen, sharded, batch, torch.Generator().manual_seed(3))
    run = serve.make_sharded_generate(CFG, mesh, eos_id=2, max_new_tokens=GEN_TOKENS)
    out = run(serve.shard_params_for_inference(mesh, base), embeds, pos, lens)
    return float(metrics["loss"]), out["tokens"]


def main(argv=None) -> int:
    from revisionllm_tpu_torch.parallel.launch import spawn

    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 8
    shape = mesh_shape(n)
    B = max(shape[0] * shape[1], 2)
    want = generate_one(B)
    results = spawn(rank_main, n, (shape, B), backend="gloo", timeout_s=300, cards=0)
    losses = {round(loss, 6) for loss, _ in results}
    if len(losses) != 1 or not all(np.isfinite(loss) for loss, _ in results):
        print(f"dryrun_multichip FAILED: the ranks' losses {sorted(losses)}", file=sys.stderr)
        return 1
    for r, (_, tokens) in enumerate(results):
        if not torch.equal(tokens, want):
            print(f"dryrun_multichip FAILED: rank {r}'s sharded generate tokens\n{tokens}\n"
                  f"vs the one-process tokens\n{want}", file=sys.stderr)
            return 1
    loss = results[0][0]
    print(f"dryrun_multichip ok: mesh {'x'.join(map(str, shape))}, loss {loss:.4f}, "
          f"sharded-generate token parity {tuple(want.shape)} exact")
    return 0


if __name__ == "__main__":
    sys.exit(main())
