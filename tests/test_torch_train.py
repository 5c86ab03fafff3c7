"""Port parity: QLoRA training (models/lora.py, forward_train, the trainer,
the optimizer and its schedule) against revisionllm_tpu on the CPU, on a
tiny f32 model with an int8 base, with weights, LoRA and adapter made by JAX
and carried across by models/weights.py. Adapter dropout is 0 here (JAX's
PRNG bits cannot be replayed); the port's dropout is held by distribution.

On the CPU the port's trainable attention runs the plain versions of the
row-4 kernels and JAX runs mha_reference; both are f32, so sums in another
order are the only difference."""

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
from revisionllm_tpu.train import optimizer as jopt
from revisionllm_tpu.train import trainer as jtrainer
from revisionllm_tpu_torch.config import AdapterConfig as TA
from revisionllm_tpu_torch.config import LoraConfig as TLo
from revisionllm_tpu_torch.config import TrainConfig as TT
from revisionllm_tpu_torch.models import adapter as tadapter
from revisionllm_tpu_torch.models import lora as tlora
from revisionllm_tpu_torch.models import revisionllm as trev
from revisionllm_tpu_torch.models.weights import params_from_numpy
from revisionllm_tpu_torch.train import optimizer as topt
from revisionllm_tpu_torch.train import trainer as ttrainer

from torch_parity import CPU, np_of, tiny_cfgs

torch.set_num_threads(2)

B, V, LQ, MAX_LEN = 2, 6, 4, 32
LR = 1e-3
ADAPTER = dict(kind="clip_encoder", d_model=16, num_heads=4, num_layers=2, ffn_dim=32,
               clip_adapter_text=True, hierarchy=False, feature_mode="temporal", dropout=0.0)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_tree(tree, requires_grad=False):
    return params_from_numpy(_np_tree(tree), CPU, requires_grad=requires_grad)


def _flat(tree):
    """{path: array} of a JAX or port tree, paths joined by '/'."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{path}/{i}")
        else:
            out[path] = np_of(t)

    walk(tree, "")
    return out


# The attention key bias wk/b gets no gradient in exact arithmetic (a bias
# added to every key shifts each query's scores by a constant, which the
# softmax removes): its computed gradient is rounding noise, and Adam turns
# noise into steps of +-lr whose sign neither side can reproduce. Updated
# trees are compared without it; test_forward_train_loss_and_grads_match_jax
# checks that its gradient is noise on both sides.
NULL_GRAD = "/wk/b"


def _assert_trees_close(got, want, rtol, what, skip=None, step_scale=0.0):
    """Leaf by leaf: |got - want| <= rtol * (max|want| + step_scale) + 1e-7
    (sums in another order; the leaf's scale keeps near-zero entries from
    dominating). Adam moves every element by about lr per step whatever the
    size of its gradient, so after n steps an updated tree's error is
    relative to step_scale = n * lr as well. Leaves whose path ends with
    `skip` are left out."""
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w), what
    for k in w:
        if skip is not None and k.endswith(skip):
            continue
        assert g[k].shape == w[k].shape, (what, k)
        tol = rtol * (np.abs(w[k]).max() + step_scale) + 1e-7
        err = np.abs(g[k] - w[k]).max()
        assert err <= tol, f"{what} {k}: max err {err:.3e} > {tol:.3e}"


@pytest.fixture(scope="module")
def setup():
    """Tiny Llama with an int8 base (dense lm_head, as train_cli keeps it),
    the ClipEncoder adapter with T2V, a LoRA whose B is perturbed away from
    0 (so A gets gradients too), and one batch of two rows of different
    lengths padded to 32."""
    jcfg, tcfg = tiny_cfgs(num_kv_heads=2)
    jbase = jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    jqbase = JQ.quantize_llama_params(jbase, quantize_lm_head=False)
    jacfg = JA(**ADAPTER, hidden_size=jcfg.hidden_size)
    tacfg = TA(**ADAPTER, hidden_size=tcfg.hidden_size)
    jvision = jrev.init_vision_params(jacfg, jax.random.PRNGKey(1), d_in=16)
    lcfg = dict(r=4, alpha=8)
    jlora_tree = jlora.init_lora(jcfg, JL(**lcfg), jax.random.PRNGKey(2))
    rng = np.random.default_rng(0)
    jlora_tree = jax.tree.map(
        lambda x: x + 0.05 * jnp.asarray(rng.normal(size=x.shape), jnp.float32), jlora_tree)
    prompts = [
        ([1, 100, 101, IMAGE_TOKEN_INDEX, 102, 103, 104, 105], [-100] * 5 + [200, 201, 2]),
        ([1, 110, IMAGE_TOKEN_INDEX, 111, 112], [-100] * 3 + [210, 2]),
    ]
    plans = stack_plans([build_splice_plan(p, V, MAX_LEN, labels=l) for p, l in prompts])
    qvalid = np.ones((B, LQ), bool)
    qvalid[1, 3:] = False
    batch_np = {
        **plans,
        "images": rng.normal(size=(B, V, 16)).astype(np.float32),
        "query_feats": rng.normal(size=(B, LQ, 16)).astype(np.float32),
        "query_valid": qvalid,
    }
    return dict(jcfg=jcfg, tcfg=tcfg, jbase=jbase, jqbase=jqbase, jacfg=jacfg, tacfg=tacfg,
                jvision=jvision, jlora=jlora_tree, lcfg=lcfg, batch_np=batch_np)


def _train_cfgs(s, **kw):
    return JT(lora=JL(**s["lcfg"]), **kw), TT(lora=TLo(**s["lcfg"]), **kw)


def _batches(s):
    jb = {k: jnp.asarray(v) for k, v in s["batch_np"].items()}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in s["batch_np"].items()}
    return jb, tb


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
def test_lora_merge_matches_jax(setup, quantized):
    """f32 einsum then add (dense) or dequantize, add, requantize (int8): the
    dense result within f32 rounding (rtol 1e-6); int8 values may round
    across a .5 boundary on one side only (within 1, under 1% of them)."""
    s = setup
    base = s["jqbase"] if quantized else s["jbase"]
    want = jlora.merge(base, s["jlora"], JL(**s["lcfg"]))
    got = tlora.merge(_torch_tree(base), _torch_tree(s["jlora"]), TLo(**s["lcfg"]))
    for name in ("q_proj", "down_proj"):
        w, g = want["layers"][name], got["layers"][name]
        if quantized:
            d = np.abs(np.asarray(w["q8"]).astype(np.int32) - g["q8"].numpy().astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() < 1e-2
            np.testing.assert_allclose(g["scale"].numpy(), np.asarray(w["scale"]), rtol=1e-6)
        else:
            np.testing.assert_allclose(np_of(g), np_of(w), rtol=1e-6, atol=1e-6)
    assert tlora.num_lora_params(_torch_tree(s["jlora"])) == jlora.num_lora_params(s["jlora"])


def test_init_lora_shapes_and_identity():
    _, tcfg = tiny_cfgs()
    gen = torch.Generator().manual_seed(0)
    tree = tlora.init_lora(tcfg, TLo(r=8, alpha=16), gen)
    for name, (din, dout) in (("q_proj", (128, 128)), ("down_proj", (256, 128))):
        a, b = tree["layers"][name]["a"], tree["layers"][name]["b"]
        assert a.shape == (tcfg.num_layers, din, 8) and b.shape == (tcfg.num_layers, 8, dout)
        assert b.abs().max() == 0 and abs(a.std().item() - din ** -0.5) < 0.2 * din ** -0.5


def _jax_loss_and_grads(s, base, jtcfg):
    jb, _ = _batches(s)
    trainable = {"lora": s["jlora"], "vision": s["jvision"]}
    loss_fn = jtrainer.make_loss_fn(s["jcfg"], s["jacfg"], jtcfg)
    return jax.jit(jax.value_and_grad(loss_fn))(trainable, {}, base, jb, jax.random.PRNGKey(3))


def _port_loss_and_grads(s, base, ttcfg):
    _, tb = _batches(s)
    trainable = {"lora": _torch_tree(s["jlora"], True), "vision": _torch_tree(s["jvision"], True)}
    loss_fn = ttrainer.make_loss_fn(s["tcfg"], s["tacfg"], ttcfg)
    leaves = ttrainer.tree_leaves(trainable)
    with ttrainer._dequant_trace():
        loss = loss_fn(trainable, {}, _torch_tree(base), tb, torch.Generator().manual_seed(3))
        grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    gtree = jax.tree.map(lambda _: next(it), trainable,
                         is_leaf=lambda x: isinstance(x, torch.Tensor))
    # tree_leaves walks dicts in sorted order, as jax.tree does
    return loss, gtree


def test_forward_train_loss_and_grads_match_jax(setup):
    """Loss and the LoRA and vision gradients of make_loss_fn over the int8
    base, inside the exact trace, against jax.value_and_grad (remat on both
    sides): f32 with sums in another order, loss within rtol 1e-5, each
    gradient leaf within 1e-4 of its largest entry."""
    s = setup
    jtcfg, ttcfg = _train_cfgs(s, gradient_checkpointing=True)
    jloss, jgrads = _jax_loss_and_grads(s, s["jqbase"], jtcfg)
    tloss, tgrads = _port_loss_and_grads(s, s["jqbase"], ttcfg)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    _assert_trees_close(tgrads["lora"], jgrads["lora"], 1e-4, "lora grad")
    _assert_trees_close(tgrads["vision"], jgrads["vision"], 1e-4, "vision grad")
    gnorm = ttrainer.global_norm(ttrainer.tree_leaves(tgrads)).item()
    for grads in (_flat(tgrads), _flat(jgrads)):
        null = [v for k, v in grads.items() if k.endswith(NULL_GRAD)]
        assert null and max(np.abs(v).max() for v in null) < 1e-6 * gnorm
    # LoRA B gets a gradient in every layer through the int8 dequant route
    for name, mats in tgrads["lora"]["layers"].items():
        assert (mats["b"].abs().flatten(1).amax(1) > 0).all(), name


def test_remat_gives_the_same_gradients(setup):
    """Recomputation is exact: the layers draw no random numbers."""
    s = setup
    grads = [_port_loss_and_grads(s, s["jqbase"], _train_cfgs(s, gradient_checkpointing=r)[1])[1]
             for r in (False, True)]
    _assert_trees_close(grads[1], grads[0], 0.0, "remat grad")


def test_forward_train_loss_on_dense_base_matches_jax(setup):
    s = setup
    jtcfg, ttcfg = _train_cfgs(s)
    jb, tb = _batches(s)
    kw = dict(lora_scale=2.0)
    jloss = jax.jit(lambda base, vision, lora, b: jrev.forward_train(
        s["jcfg"], s["jacfg"], base, vision, {k: b[k] for k in ttrainer.PLAN_KEYS}, b["images"],
        b["query_feats"], b["query_valid"], lora=lora, **kw))(s["jbase"], s["jvision"], s["jlora"], jb)
    tloss = trev.forward_train(s["tcfg"], s["tacfg"], _torch_tree(s["jbase"]),
                               _torch_tree(s["jvision"]), {k: tb[k] for k in ttrainer.PLAN_KEYS},
                               tb["images"], tb["query_feats"], tb["query_valid"],
                               lora=_torch_tree(s["jlora"]), **kw)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("kind", ["cosine", "constant"])
@pytest.mark.parametrize("total", [1, 10, 137])
def test_lr_schedule_matches_optax(kind, total):
    """Python floats against optax's f32: within f32 rounding, every step
    and a few past the end."""
    j = jopt.cosine_schedule(JT(lr_scheduler=kind), total)
    t = topt.cosine_schedule(TT(lr_scheduler=kind), total)
    want = np.asarray([float(j(i)) for i in range(total + 3)])
    got = np.asarray([t(i) for i in range(total + 3)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert got[0] == 0.0  # optax's first update uses schedule(0)


def _run_steps(s, n_steps, accumulation):
    """n_steps train steps of both packages from the same trees; returns
    (JAX metrics, port metrics, JAX trainable, port trainable)."""
    kw = dict(learning_rate=LR, gradient_accumulation=accumulation, weight_decay=0.01,
              gradient_checkpointing=True)
    jtcfg, ttcfg = _train_cfgs(s, **kw)
    jb, tb = _batches(s)
    jtr = {"lora": s["jlora"], "vision": s["jvision"]}
    optimizer = jopt.make_optimizer(jtcfg, total_steps=n_steps)
    opt_state = optimizer.init(jtr)
    jstep = jax.jit(jtrainer.make_train_step(s["jcfg"], s["jacfg"], jtcfg, optimizer))
    ttr = {"lora": _torch_tree(s["jlora"], True), "vision": _torch_tree(s["jvision"], True)}
    topt_ = topt.AdamW(ttrainer.tree_leaves(ttr), ttcfg, total_steps=n_steps)
    tstep = ttrainer.make_train_step(s["tcfg"], s["tacfg"], ttcfg, topt_)
    tbase = _torch_tree(s["jqbase"])
    jm, tm = [], []
    for i in range(n_steps):
        jtr, opt_state, m = jstep(jtr, {}, s["jqbase"], opt_state, jb, jax.random.PRNGKey(i))
        jm.append({k: float(v) for k, v in m.items()})
        m = tstep(ttr, {}, tbase, tb, torch.Generator().manual_seed(i))
        tm.append({k: float(v) for k, v in m.items()})
    return jm, tm, jtr, ttr


def test_three_train_steps_match_jax(setup):
    """Loss, grad norm and the updated trainable tree after each of 3 steps
    of make_train_step (AdamW, cosine warmup, weight decay, remat) against
    JAX's, rtol 1e-4."""
    jm, tm, jtr, ttr = _run_steps(setup, 3, 1)
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-4)
    assert tm[2]["loss"] != tm[1]["loss"]  # step 0 used lr 0; step 1 moved
    _assert_trees_close(ttr, jtr, 1e-4, "trainable after 3 steps", skip=NULL_GRAD,
                        step_scale=3 * LR)


def test_gradient_accumulation_matches_multisteps(setup):
    """gradient_accumulation = 2 against optax.MultiSteps: the parameters
    move only on every second micro-step, by the mean gradient."""
    jm, tm, jtr, ttr = _run_steps(setup, 4, 2)
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
    _assert_trees_close(ttr, jtr, 1e-4, "trainable after 4 micro-steps", skip=NULL_GRAD,
                        step_scale=2 * LR)


def test_dropout_keep_rate_by_distribution():
    """JAX's bits cannot be replayed: the keep rate is 1 - p within 5
    standard deviations and kept values are scaled by 1 / (1 - p)."""
    x = torch.ones(200_000)
    for p in (0.1, 0.5):
        y = tadapter.dropout(x, p, torch.Generator().manual_seed(0))
        kept = y != 0
        sd = (p * (1 - p) / x.numel()) ** 0.5
        assert abs(kept.float().mean().item() - (1 - p)) < 5 * sd
        np.testing.assert_allclose(y[kept].numpy(), 1 / (1 - p), rtol=1e-6)
    assert tadapter.dropout(x, 0.1, None) is x


def test_training_mode_adapter_uses_the_generator(setup):
    """deterministic=False with dropout > 0 changes the output, the same
    generator seed repeats it, and deterministic=True ignores it."""
    s = setup
    acfg = TA(**{**ADAPTER, "dropout": 0.1}, hidden_size=s["tcfg"].hidden_size)
    vision = _torch_tree(s["jvision"])
    _, tb = _batches(s)
    args = (acfg, vision, tb["images"], tb["query_feats"], tb["query_valid"])

    def run(det, seed):
        return trev.encode_video(*args, deterministic=det,
                                 generator=torch.Generator().manual_seed(seed))

    a, b, c = run(False, 0), run(False, 0), run(False, 1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(run(True, 0), run(True, 1))
    with pytest.raises(ValueError, match="Generator"):
        trev.encode_video(*args, deterministic=False)


def test_weights_bridge_carries_lora_and_bf16_vision_trees(setup):
    """LoRA (f32) and a bf16 vision tree, as JAX holds them on the chip,
    come across bit for bit, with requires_grad on request."""
    s = setup
    vis16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16), s["jvision"])
    got = params_from_numpy(_np_tree(vis16), CPU, requires_grad=True)
    g, w = _flat(got), _flat(vis16)
    for k in w:
        assert np.array_equal(g[k], w[k]), k
    assert got["mm_projector"]["mm_projector"]["w"].dtype == torch.bfloat16
    assert all(t.requires_grad for t in ttrainer.tree_leaves(got))
    lora = params_from_numpy(_np_tree(s["jlora"]), CPU)
    assert lora["layers"]["q_proj"]["a"].dtype == torch.float32
    assert not lora["layers"]["q_proj"]["a"].requires_grad


def test_build_trainable_stage_machine(setup):
    s = setup
    vision = _torch_tree(s["jvision"])
    prior = _torch_tree(s["jlora"])
    gen = torch.Generator().manual_seed(0)
    lc = TLo(**s["lcfg"])
    tr, fr = ttrainer.build_trainable(s["tcfg"], TT(training_stage=2, lora=lc), vision, gen)
    assert set(tr) == {"vision", "lora"} and not fr
    assert all(t.requires_grad for t in ttrainer.tree_leaves(tr))
    tr, fr = ttrainer.build_trainable(s["tcfg"], TT(training_stage=1, lora=lc), vision, gen, prior)
    assert set(tr) == {"vision"} and set(fr) == {"lora"}
    assert not any(t.requires_grad for t in ttrainer.tree_leaves(fr))
    tr, fr = ttrainer.build_trainable(s["tcfg"], TT(training_stage=4, lora=lc), vision, gen, prior)
    assert tr["lora"] is prior
    tr, fr = ttrainer.build_trainable(
        s["tcfg"], TT(tune_mm_mlp_adapter=True, lora=lc), vision, gen, prior)
    assert set(tr) == {"vision"} and set(fr) == {"lora"}
