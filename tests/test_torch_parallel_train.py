"""Port parity: the sharded train step (trainer.make_grad_fn and
make_sharded_train_step over the mesh paths of models/llama.py and
forward_train) against revisionllm_tpu's make_sharded_train_step on the
same mesh and batch, on the CPU: tests/test_torch_train.py's tiny f32 model
with an int8 base, the T2V ClipEncoder adapter and a LoRA whose B is moved
away from 0, a batch of 4 rows, remat on. The port's side runs in gloo ranks
(in a thread, while JAX compiles here); JAX's on the virtual 8-device mesh.

At adapter dropout 0 (JAX's PRNG bits cannot be replayed), the first
step's loss is held within 1e-5 relative and every trainable leaf after two
steps within 1e-4 relative L2 of JAX's; every gradient leaf within 1e-4
relative L2 of the port's one-process gradient. With dropout on, the
sharded step is held to the port's one-process step by the same limits:
every rank draws the noise of the whole batch from the same generator.
This file holds the data and fsdp meshes; test_torch_parallel_train_tp.py
the tensor ones, three steps and train_cli over two ranks."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revisionllm_tpu.config import AdapterConfig as JA
from revisionllm_tpu.config import LoraConfig as JL
from revisionllm_tpu.config import TrainConfig as JT
from revisionllm_tpu.constants import IMAGE_TOKEN_INDEX
from revisionllm_tpu.models import llama as jllama
from revisionllm_tpu.models import lora as jlora
from revisionllm_tpu.models import revisionllm as jrev
from revisionllm_tpu.models.multimodal import build_splice_plan, stack_plans
from revisionllm_tpu.ops import quant as JQ
from revisionllm_tpu.parallel import mesh as jmesh
from revisionllm_tpu.parallel import sharding as jshard
from revisionllm_tpu.train import optimizer as jopt
from revisionllm_tpu.train import trainer as jtrainer
from revisionllm_tpu_torch.config import AdapterConfig as TA
from revisionllm_tpu_torch.config import LoraConfig as TLo
from revisionllm_tpu_torch.config import TrainConfig as TT
from revisionllm_tpu_torch.models.weights import params_from_numpy
from revisionllm_tpu_torch.train import optimizer as topt
from revisionllm_tpu_torch.train import trainer as ttrainer

from torch_parallel_cases import run_ranks, train_case
from torch_parity import tiny_cfgs

B, V, LQ, MAX_LEN = 4, 6, 4, 32
ADAPTER = dict(kind="clip_encoder", d_model=16, num_heads=4, num_layers=2, ffn_dim=32,
               clip_adapter_text=True, hierarchy=False, feature_mode="temporal")
TRAIN = dict(learning_rate=1e-3, weight_decay=0.01, gradient_checkpointing=True)
LORA = dict(r=4, alpha=8)
DROPOUT = 0.1
STEPS = 2
# The attention key bias gets no gradient in exact arithmetic (it shifts a
# query's scores by a constant, which the softmax removes): both sides
# compute rounding noise there (tests/test_torch_train.py's NULL_GRAD). Its
# gradient is held against its query bias's norm, and Adam turns the noise
# into +-lr steps whose signs neither side reproduces, so the updated leaf
# is left out.
NULL_GRAD = "/wk/b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def setup():
    """The JAX trees and the batch (numpy), with both packages' configs."""
    jcfg, tcfg = tiny_cfgs(num_kv_heads=2)
    base = JQ.quantize_llama_params(jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32),
                                    quantize_lm_head=False)
    jacfg = JA(**ADAPTER, hidden_size=jcfg.hidden_size, dropout=0.0)
    vision = jrev.init_vision_params(jacfg, jax.random.PRNGKey(1), d_in=16)
    lora = jlora.init_lora(jcfg, JL(**LORA), jax.random.PRNGKey(2))
    rng = np.random.default_rng(0)
    lora = jax.tree.map(lambda x: x + 0.05 * jnp.asarray(rng.normal(size=x.shape), jnp.float32),
                        lora)
    prompts = [
        ([1, 100, 101, IMAGE_TOKEN_INDEX, 102, 103, 104, 105], [-100] * 5 + [200, 201, 2]),
        ([1, 110, IMAGE_TOKEN_INDEX, 111, 112], [-100] * 3 + [210, 2]),
        ([1, 120, 121, 122, IMAGE_TOKEN_INDEX, 123], [-100] * 5 + [2]),
        ([1, IMAGE_TOKEN_INDEX, 130, 131, 132, 133, 134], [-100] * 4 + [220, 221, 2]),
    ]
    plans = stack_plans([build_splice_plan(p, V, MAX_LEN, labels=l) for p, l in prompts])
    qvalid = np.ones((B, LQ), bool)
    qvalid[1, 3:] = False
    batch = {**plans, "images": rng.normal(size=(B, V, 16)).astype(np.float32),
             "query_feats": rng.normal(size=(B, LQ, 16)).astype(np.float32),
             "query_valid": qvalid}
    return {"jcfg": jcfg, "tcfg": tcfg, "jacfg": jacfg, "jtcfg": JT(lora=JL(**LORA), **TRAIN),
            "tcfgs": [(tcfg, TA(**ADAPTER, hidden_size=tcfg.hidden_size, dropout=d),
                       TT(lora=TLo(**LORA), **TRAIN)) for d in (0.0, DROPOUT)],
            "trees": {"base": base, "vision": vision, "lora": lora}, "batch": batch}


def jax_reference(s, shapes, steps):
    """JAX at dropout 0: `steps` steps of make_sharded_train_step on each mesh
    of `shapes`: {shape: (the first step's loss, the trainable leaves after
    the last step)}."""
    trees, jb = s["trees"], {k: jnp.asarray(v) for k, v in s["batch"].items()}
    trainable = {"lora": trees["lora"], "vision": trees["vision"]}
    out = {}
    for shape in shapes:
        mesh = jmesh.create_mesh(*shape)
        optimizer = jopt.make_optimizer(s["jtcfg"], total_steps=50)
        tr = jax.tree.map(jnp.array, trainable)
        state = optimizer.init(tr)
        base = jshard.shard_params(mesh, trees["base"], jshard.llama_param_specs(trees["base"]))
        step = jtrainer.make_sharded_train_step(s["jcfg"], s["jacfg"], s["jtcfg"], optimizer, mesh)
        losses = []
        with mesh:
            for i in range(steps):
                tr, state, metrics = step(tr, {}, base, state, jb, jax.random.PRNGKey(i))
                losses.append(float(metrics["loss"]))
        out[shape] = (losses[0], [np.asarray(t) for t in jax.tree.leaves(tr)])
    return out


def port_one_process(s, case, steps):
    """The port's one-process loss, gradients and `steps` steps under
    s["tcfgs"][case] (0: dropout 0, 1: dropout on)."""
    cfg, acfg, tcfg = s["tcfgs"][case]
    cpu = torch.device("cpu")
    trainable = {k: params_from_numpy(_np(s["trees"][k]), cpu, requires_grad=True)
                 for k in ("lora", "vision")}
    base = params_from_numpy(_np(s["trees"]["base"]), cpu)
    batch = {k: torch.as_tensor(v) for k, v in s["batch"].items()}
    leaves = ttrainer.tree_leaves(trainable)
    loss_fn = ttrainer.make_loss_fn(cfg, acfg, tcfg)
    with ttrainer._dequant_trace():
        loss = loss_fn(trainable, {}, base, batch, torch.Generator().manual_seed(3))
        grads = torch.autograd.grad(loss, leaves)
    opt = topt.AdamW(leaves, tcfg, 50)
    step = ttrainer.make_train_step(cfg, acfg, tcfg, opt)
    gen = torch.Generator().manual_seed(3)
    losses = [float(step(trainable, {}, base, batch, gen)["loss"]) for _ in range(steps)]
    return {"loss": loss.item(), "grads": [g.numpy() for g in grads], "losses": losses,
            "leaves": [t.detach().numpy() for t in leaves]}


def leaf_names(s):
    """trainer.tree_leaves order (sorted keys, as jax.tree.leaves)."""
    def walk(t, path):
        if isinstance(t, dict):
            return [n for k in sorted(t) for n in walk(t[k], f"{path}/{k}")]
        if isinstance(t, (list, tuple)):
            return [n for i, v in enumerate(t) for n in walk(v, f"{path}/{i}")]
        return [path]
    return walk({"lora": s["trees"]["lora"], "vision": s["trees"]["vision"]}, "")


def rel_l2(got, want, ref=None):
    ref = want if ref is None else ref
    r = float(np.linalg.norm(ref))
    e = float(np.linalg.norm(np.asarray(got, np.float64) - np.asarray(want, np.float64)))
    return e / r if r > 0 else e


def assert_grads_close(names, got, want, tol, what):
    for n, g, w in zip(names, got, want):
        ref = want[names.index(n[:-len(NULL_GRAD)] + "/wq/b")] if n.endswith(NULL_GRAD) else w
        assert rel_l2(g, w, ref) <= tol, f"{what} {n}: relative L2 {rel_l2(g, w, ref):.3e}"


def assert_leaves_close(names, got, want, tol, what):
    for n, g, w in zip(names, got, want):
        if not n.endswith(NULL_GRAD):
            assert rel_l2(g, w) <= tol, f"{what} {n}: relative L2 {rel_l2(g, w):.3e}"


def run_both(shapes, steps=STEPS):
    """The port's ranks on each mesh of `shapes` (a thread), JAX's
    reference here, and the port's one-process run with dropout."""
    s = setup()
    trees = {k: _np(v) for k, v in s["trees"].items()}
    ranks, errors = {}, []

    def port_side():
        try:
            for shape in shapes:
                ranks[shape] = run_ranks(train_case, int(np.prod(shape)), shape, s["tcfgs"],
                                         trees, s["batch"], steps)
        except Exception as e:  # raised in the test's thread below
            errors.append(e)

    worker = threading.Thread(target=port_side)
    worker.start()
    want = jax_reference(s, shapes, steps)
    one = [port_one_process(s, case, steps) for case in range(2)]
    worker.join(timeout=400)
    if errors:
        raise errors[0]
    assert not worker.is_alive(), "the port's ranks did not finish"
    return {"names": leaf_names(s), "jax": want, "one": one, "ranks": ranks}


def check_mesh(res, shape):
    """Every rank of `shape`: at dropout 0 the loss and the updated leaves
    against JAX's sharded step on the same mesh, and the gradients against
    the port's one-process ones (tests/test_torch_train.py holds those to
    jax.value_and_grad); with dropout, all of it against the port's
    one-process step."""
    names, (first_loss, jax_leaves) = res["names"], res["jax"][shape]
    for r, (plain, dropped) in enumerate(res["ranks"][shape]):
        what = f"mesh {shape} rank {r}"
        np.testing.assert_allclose(plain["loss"], first_loss, rtol=1e-5, err_msg=what)
        np.testing.assert_allclose(plain["losses"][0], first_loss, rtol=1e-5, err_msg=what)
        assert_leaves_close(names, plain["leaves"], jax_leaves, 1e-4, f"{what} leaf")
        one = res["one"][0]
        np.testing.assert_allclose(plain["loss"], one["loss"], rtol=1e-5, err_msg=what)
        assert_grads_close(names, plain["grads"], one["grads"], 1e-4, f"{what} grad")
        one = res["one"][1]
        np.testing.assert_allclose(dropped["loss"], one["loss"], rtol=1e-5, err_msg=what)
        np.testing.assert_allclose(dropped["losses"], one["losses"], rtol=1e-5, err_msg=what)
        assert_grads_close(names, dropped["grads"], one["grads"], 1e-4, f"{what} dropout grad")
        assert_leaves_close(names, dropped["leaves"], one["leaves"], 1e-4,
                            f"{what} dropout leaf")
        assert abs(dropped["loss"] - plain["loss"]) > 1e-6, "the dropout changed nothing"


DATA_FSDP = [(2, 1, 1), (1, 2, 1)]


@pytest.fixture(scope="module")
def results():
    return run_both(DATA_FSDP)


@pytest.mark.parametrize("shape", DATA_FSDP, ids=["data2", "fsdp2"])
def test_sharded_step_matches_jax_and_one_process(results, shape):
    check_mesh(results, shape)


def test_ranks_agree(results):
    """The reduced gradients, the losses and the updated trees are the
    same on every rank (each rank's optimizer makes the same update)."""
    for shape, ranks in results["ranks"].items():
        for case in range(2):
            first = ranks[0][case]
            for other in ranks[1:]:
                assert other[case]["losses"] == first["losses"]
                for a, b in zip(other[case]["leaves"], first["leaves"]):
                    np.testing.assert_array_equal(a, b)


def test_uneven_batch_raises():
    """A batch the (data, fsdp) ranks cannot split evenly is refused."""
    from torch_parallel_cases import fake_rank
    from revisionllm_tpu_torch.models import revisionllm as trev

    s = setup()
    cfg, acfg, _ = s["tcfgs"][0]
    plan = {k: torch.as_tensor(v[:3]) for k, v in s["batch"].items()
            if k in ttrainer.PLAN_KEYS}
    with pytest.raises(ValueError, match="does not split"):
        trev.forward_train(cfg, acfg, {}, params_from_numpy(_np(s["trees"]["vision"]),
                                                            torch.device("cpu")),
                           plan, torch.as_tensor(s["batch"]["images"][:3]),
                           mesh=fake_rank((2, 1, 1), 0))
