"""Rank functions for the port's multi-process tests
(tests/test_torch_parallel_*.py). Each runs in a gloo rank on the CPU that
revisionllm_tpu_torch.parallel.launch.spawn starts, so this module imports
torch, numpy and the port only: the JAX side runs in the test's own process.
Trees and inputs arrive as numpy arrays; results go back as numpy arrays or
CPU tensors."""

import argparse

import numpy as np
import torch

TIMEOUT_S = 240.0   # a rank that hangs fails its test within this


def run_ranks(fn, n, *args):
    """fn(*args) in n gloo ranks on the CPU; their results in rank order."""
    from revisionllm_tpu_torch.parallel.launch import spawn

    return spawn(fn, n, args, backend="gloo", timeout_s=TIMEOUT_S, cards=0)


def _tree(np_tree, grad=False):
    from revisionllm_tpu_torch.models.weights import params_from_numpy

    return params_from_numpy(np_tree, torch.device("cpu"), requires_grad=grad)


def mesh_facts():
    """create_mesh(2, 2, 2) in a world of 8: axis names, shape, this rank's
    coordinates and each group's size; and the messages of the meshes the
    world cannot hold (more ranks, and fewer)."""
    import torch.distributed as dist

    from revisionllm_tpu_torch.parallel import launch
    from revisionllm_tpu_torch.parallel import mesh as mesh_lib

    m = mesh_lib.create_mesh(2, 2, 2)
    out = {"axes": m.axis_names, "shape": m.devices_shape, "device_mesh": m.device_mesh.shape,
           "coord": {a: m.coord(a) for a in ("data", "fsdp", "tensor", "batch", "world")},
           "group_size": {a: dist.get_world_size(m.group(a))
                          for a in ("data", "fsdp", "tensor", "batch", "world")},
           "process": (launch.process_index(), launch.process_count()),
           "shard": list(launch.host_shard_indices(13))}
    for shape in ((4, 4, 1), (2, 1, 1)):
        try:
            mesh_lib.create_mesh(*shape)
            out[shape] = None
        except ValueError as e:
            out[shape] = str(e)
    return out


def serve_cases(cfg, trees, gen_inputs, engine_case, stage1_case, surfaces_case):
    """Everything the serving tests hold, in one world of 8 at (2, 2, 2):
    sharded_generate for each case of `gen_inputs` ({"tree[+switch...]":
    inputs}, the tree from `trees`; "glm...": (config, tree, inputs,
    prefix)); GroundingEngine(mesh=...).ground_windows; stage1.run with
    a mesh engine writing into stage1_case's log path; and the other
    surfaces of surfaces_case (engine_surfaces)."""
    from revisionllm_tpu_torch.eval import stage1
    from revisionllm_tpu_torch.eval.engine import GroundingEngine
    from revisionllm_tpu_torch.parallel import mesh as mesh_lib
    from revisionllm_tpu_torch.utils.testing import FakeTokenizer

    torch.set_num_threads(1)
    mesh = mesh_lib.create_mesh(2, 2, 2)
    out = {"generate": {}}
    for name, inputs in gen_inputs.items():
        if name.startswith("glm"):  # (config, tree, inputs, P-tuning prefix)
            glm_cfg, tree, inputs, prefix = inputs
            out["generate"][name] = sharded_generate(glm_cfg, mesh, _tree(tree), inputs,
                                                     prefix=prefix)
            continue
        out["generate"][name] = sharded_generate(cfg, mesh, _tree(trees[name.split("+")[0]]),
                                                 inputs, name.split("+")[1:])

    def engine(kind, ecfg):
        cfg_e, acfg, params, vision = kind
        tok = FakeTokenizer()
        for i in range(300):
            tok._id(str(i))
        return GroundingEngine(cfg_e, acfg, _tree(params), _tree(vision), tok, ecfg,
                               device="cpu", mesh=mesh)

    kind, ecfg, feats, sentence = engine_case
    res = engine(kind, ecfg).ground_windows(feats, sentence)
    out["engine"] = {"answers": res["answers"], "scores_entropy": res["scores_entropy"]}
    kind, ecfg, args = stage1_case
    out["stage1"] = stage1.run(argparse.Namespace(**args), engine(kind, ecfg))
    out["surfaces"] = engine_surfaces(mesh, *surfaces_case)
    return out


def engine_surfaces(mesh, s1, s2, feats):
    """ground_windows_batch and caption_windows on the stage-1 engine,
    retrieve and retrieve_batch on the stage-2 one (each (config, adapter
    config, numpy trees, eval config)), over `mesh` or in one process (mesh
    None), on the movie `feats`: their answers and scores."""
    from revisionllm_tpu_torch.eval.engine import GroundingEngine
    from revisionllm_tpu_torch.utils.testing import FakeTokenizer

    def engine(kind):
        cfg, acfg, params, vision, ecfg = kind
        tok = FakeTokenizer()
        for i in range(300):
            tok._id(str(i))
        return GroundingEngine(cfg, acfg, _tree(params), _tree(vision), tok, ecfg,
                               device="cpu", mesh=mesh)

    e1, e2 = engine(s1), engine(s2)
    sentences = ("a red car drives by", "someone opens a door")
    batch = e1.ground_windows_batch(feats, [{"sentence": s} for s in sentences])
    cap = e1.caption_windows(feats)
    ret = e2.retrieve(feats, sentences[0], rng=np.random.default_rng(0))
    rets = e2.retrieve_batch(feats, [{"sentence": s, "rng": np.random.default_rng(i)}
                                     for i, s in enumerate(sentences)])
    return {"batch": [(r["answers"], r["scores_entropy"]) for r in batch],
            "caption": cap["answers"],
            "retrieve": (ret["answers"], ret["mean_entropy"]),
            "retrieve_batch": [(r["answers"], r["mean_entropy"]) for r in rets]}


def sharded_generate(cfg, mesh, params, inputs, switches=(), prefix=None):
    """make_sharded_generate over `mesh` on the whole tree `params` and
    inputs (embeds, positions, lens, G), with the W8A8 prefill ("w8a8"),
    the fused MLP ("fused") or the shared-prefix prefill of the rows' first
    3 positions ("shared") switched on, and a P-tuning `prefix` (pk, pv):
    the outputs and the prefill's logits, every row."""
    from revisionllm_tpu_torch.models import llama
    from revisionllm_tpu_torch.ops import quant
    from revisionllm_tpu_torch.parallel import mesh as mesh_lib
    from revisionllm_tpu_torch.parallel import serve

    emb, pos, lens, G = (torch.as_tensor(np.array(x)) if isinstance(x, np.ndarray) else x
                         for x in inputs)
    kw = {"shared_prefix_len": 3 if "shared" in switches else 0}
    if prefix is not None:
        kw["prefix_kv"] = tuple(torch.as_tensor(np.array(t)) for t in prefix)
    quant.set_w8a8(True if "w8a8" in switches else None)
    llama.set_fused_mlp(True if "fused" in switches else None)
    try:
        shard = mesh_lib.batch_sharding(mesh)
        local = serve.shard_params_for_inference(mesh, params)
        res = serve.make_sharded_generate(cfg, mesh, eos_id=2, max_new_tokens=G, **kw)(
            local, emb, pos, lens)
        B = emb.shape[0]
        logits, _ = llama.prefill_kv(cfg, local, shard.local(emb, B), shard.local(pos, B),
                                     kv_lens=shard.local(lens, B),
                                     prefix_kv=kw.get("prefix_kv"), mesh=mesh)
        res["prefill_logits"] = shard.gather(logits, B)
    finally:
        quant.set_w8a8(None)
        llama.set_fused_mlp(None)
    return {k: v.numpy() for k, v in res.items()}


def train_case(shape, cfgs, trees, batch_np, steps):
    """On this rank of `shape`, for each (llama, adapter, train) config of
    `cfgs`: the whole batch's loss and reduced gradients from make_grad_fn
    over the mesh, then `steps` steps of make_sharded_train_step from the
    same trees (the generator seeded 3 both times): each step's loss and
    the trainable leaves after the last. trees: numpy {"base", "vision",
    "lora"}."""
    from revisionllm_tpu_torch.parallel import mesh as mesh_lib
    from revisionllm_tpu_torch.parallel import sharding
    from revisionllm_tpu_torch.train import optimizer as opt_lib
    from revisionllm_tpu_torch.train import trainer

    torch.set_num_threads(1)
    mesh = mesh_lib.create_mesh(*shape)
    base = _tree(trees["base"])
    base = sharding.shard_params(mesh, base, sharding.llama_param_specs(base))
    batch = {k: torch.as_tensor(v) for k, v in batch_np.items()}
    out = []
    for cfg, acfg, tcfg in cfgs:
        trainable = {"lora": _tree(trees["lora"], True), "vision": _tree(trees["vision"], True)}
        leaves = trainer.tree_leaves(trainable)
        loss, grads = trainer.make_grad_fn(cfg, acfg, tcfg, mesh=mesh)(
            trainable, {}, base, batch, torch.Generator().manual_seed(3), leaves)
        opt = opt_lib.AdamW(leaves, tcfg, 50)
        step = trainer.make_sharded_train_step(cfg, acfg, tcfg, opt, mesh)
        gen = torch.Generator().manual_seed(3)
        losses = [float(step(trainable, {}, base, batch, gen)["loss"]) for _ in range(steps)]
        out.append({"loss": float(loss), "grads": [g.numpy() for g in grads], "losses": losses,
                    "leaves": [t.detach().numpy().copy() for t in leaves]})
    return out


def train_cli_case(argv):
    """train_cli.main over this world (its --dp/--fsdp/--tp): this rank's
    trainable leaves at the end, and the checkpoint directories it wrote."""
    from revisionllm_tpu_torch.train import checkpoint as ckpt
    from revisionllm_tpu_torch.train import train_cli, trainer

    torch.set_num_threads(1)
    written, write = [], ckpt._write
    ckpt._write = lambda path, state: (written.append(path), write(path, state))
    run, _ = train_cli.main(argv)
    return [t.detach().numpy() for t in trainer.tree_leaves(run.trainable)], written


def fake_rank(shape, rank):
    """A (dp, fsdp, tp) mesh as rank `rank` sees it, without a process
    group: enough for shard_params (which only slices) and for the paths
    that refuse a mesh before their first collective."""
    from revisionllm_tpu_torch.parallel.mesh import Mesh

    m = Mesh(*shape)
    dp, fsdp, tp = shape
    m._coord = {"data": rank // (fsdp * tp), "fsdp": (rank // tp) % fsdp, "tensor": rank % tp}
    return m
