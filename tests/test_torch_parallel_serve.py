"""Port parity: sharded serving (revisionllm_tpu_torch/parallel/serve.py,
the mesh paths of models/llama.py and generation.py, GroundingEngine(mesh=),
eval/stage1.py's rank-0 writes) against revisionllm_tpu's sharded programs
on the CPU, the port's side in 8 gloo ranks at mesh (2, 2, 2), JAX's on the
8-device virtual mesh tests/conftest.py pins:

- make_sharded_generate on tests/test_parallel_train.py's tiny f32 tree and
  its int8 tree, with the shared-prefix prefill, and on ChatGLM2's geometry
  with a P-tuning prefix: the tokens equal JAX's serve.make_sharded_generate,
  the entropies, log-probabilities and the prefill's logits within 1e-5
  relative; with the W8A8 prefill and the fused MLP (JAX's Pallas kernel in
  interpret mode) on, the tokens equal JAX's and the values within one int8
  rounding step;
- GroundingEngine(mesh=...).ground_windows on TestMeshServingEngine's
  inputs: the answers equal JAX's GroundingEngine(mesh=create_mesh(2,2,2));
  its other surfaces (ground_windows_batch, caption_windows, retrieve,
  retrieve_batch) equal the port's one-process engine;
- stage1.run over a mesh engine: rank 0 alone writes, and the file equals
  the one-process run's;
- the refusals: the megakernel (row 9) and a serving-packed tree (row 10)
  under tensor parallelism, int4 weights whose K does not split into whole
  groups, a mesh larger than the world."""

import argparse
import functools
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revisionllm_tpu.config import AdapterConfig as JAdapter
from revisionllm_tpu.config import EvalConfig as JEval
from revisionllm_tpu.config import LlamaConfig as JCfg
from revisionllm_tpu.eval.engine import GroundingEngine as JEngine
from revisionllm_tpu.models import llama as jllama
from revisionllm_tpu.models import revisionllm as jrl
from revisionllm_tpu.ops import quant as JQ
from revisionllm_tpu.ops.quant import quantize_llama_params
from revisionllm_tpu.parallel import mesh as jmesh
from revisionllm_tpu.parallel import serve as jserve
from revisionllm_tpu.utils.testing import FakeTokenizer as JTok
from revisionllm_tpu_torch.config import AdapterConfig as TAdapter
from revisionllm_tpu_torch.config import EvalConfig as TEval
from revisionllm_tpu_torch.config import LlamaConfig as TCfg
from revisionllm_tpu_torch.eval import loader as tloader
from revisionllm_tpu_torch.eval import stage1 as tstage1
from revisionllm_tpu_torch.models import generation as tgen
from revisionllm_tpu_torch.models import llama as tllama
from revisionllm_tpu_torch.ops import decode_serve as TDSV
from revisionllm_tpu_torch.parallel import serve as tserve

from torch_parallel_cases import engine_surfaces, fake_rank, run_ranks, serve_cases
from test_torch_glm import GLM, glm_params
from torch_parity import S1_EVAL, assert_records_equal, engines, records

S2_EVAL = dict(debug_window=20, num_frames=16, feature_fps=2.0, batch=8, stride=5,
               max_new_tokens=4, hierarchy_zooms=(2, 1))   # test_torch_pipeline.py's

TINY = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
            num_heads=4, num_kv_heads=4, head_dim=32, dtype="float32")
ADAPTER = dict(d_model=32, num_heads=4, num_layers=2, ffn_dim=64, hidden_size=128,
               clip_adapter_text=True, hierarchy=False, feature_mode="temporal")
ENGINE_EVAL = dict(debug_window=20, num_frames=16, feature_fps=2.0, batch=8, stride=2,
                   max_new_tokens=4)
GEN = {"f32": (4, 6, 5, 0), "int8": (4, 5, 3, 1)}   # B, P, G, seed of the ids


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _eval_data(root):
    """A 200 s movie at 2 fps of 16-d features, two queries with token and
    CLS features (tests/test_torch_pipeline.py's eval_data)."""
    rng = np.random.default_rng(0)
    np.save(root / "m1.npy", rng.normal(size=(400, 16)).astype(np.float32))
    data = {"q1": {"movie": "m1", "movie_duration": 200.0, "timestamps": [50.0, 60.0],
                   "query": "a red car drives by."},
            "q2": {"movie": "m1", "movie_duration": 200.0, "timestamps": [100.0, 110.0],
                   "query": "someone opens a door?"}}
    (root / "val.json").write_text(json.dumps(data))
    (root / "qfeats").mkdir()
    for qid in data:
        np.savez(root / "qfeats" / f"{qid}.npz",
                 token_features=rng.normal(size=(5, 16)).astype(np.float32),
                 cls_features=rng.normal(size=(16,)).astype(np.float32))


def _stage1_args(root, log_path):
    return dict(data_path=str(root / "val.json"), feat_folder=str(root),
                q_feat_dir=str(root / "qfeats"), debug_window=20, num_frames=16,
                feature_fps=2.0, split=0, total_split=1, debug=True, query_batch=1,
                log_path=str(log_path), batch=4, score="mean_entropy", score_merge="multiply",
                normalize=True, topk_pool=True, skip_small_videos=True,
                mad_prompt="mad_grounding", max_new_tokens=6)


def _jax_sharded_generate(cfg, mesh, tree, inputs, switches=(), prefix=None):
    """JAX's make_sharded_generate over `mesh` on `tree` and inputs
    (embeds, positions, lens, G), with the switches of sharded_generate
    (the fused MLP's Pallas kernel in interpret mode) and a P-tuning
    `prefix`: its outputs and the prefill's logits, every row."""
    emb, pos, lens, G = (jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in inputs)
    kw = {"shared_prefix_len": 3 if "shared" in switches else 0}
    if prefix is not None:
        kw["prefix_kv"] = tuple(jnp.asarray(t) for t in prefix)
    JQ.set_w8a8(True if "w8a8" in switches else None)
    jllama._FUSED_MLP = "fused" in switches
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JQ, "w8a8_mlp_fused",
                       functools.partial(JQ.w8a8_mlp_fused, interpret=True))
            sharded = jserve.shard_params_for_inference(mesh, tree)
            run = jserve.make_sharded_generate(cfg, mesh, eos_id=2, max_new_tokens=G, **kw)
            with mesh:
                out = run(sharded, emb, pos, lens)
                logits = jax.jit(lambda p: jllama.prefill_kv(
                    cfg, p, emb, pos, kv_lens=lens, prefix_kv=kw.get("prefix_kv"))[0])(sharded)
    finally:
        JQ.set_w8a8(None)
        jllama._FUSED_MLP = None
    return {**_np(out), "prefill_logits": np.asarray(logits)}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The port's ranks run every case (in a thread, while JAX's sharded
    programs and the port's one-process stage-1 run in this process)."""
    root = tmp_path_factory.mktemp("served")
    _eval_data(root)
    jcfg, tcfg = JCfg(**TINY), TCfg(**TINY)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    trees = {"f32": params, "int8": quantize_llama_params(params)}
    vision = jrl.init_vision_params(JAdapter(**ADAPTER), jax.random.PRNGKey(1), d_in=32)
    gen_inputs = {}
    for name, (B, P, G, seed) in GEN.items():
        ids = jnp.asarray(np.random.default_rng(seed).integers(3, jcfg.vocab_size, (B, P)))
        gen_inputs[name] = (np.asarray(jllama.embed_tokens(trees[name], ids)),
                            np.broadcast_to(np.arange(P), (B, P)).copy(),
                            np.full((B,), P, np.int32), G)
    # the W8A8 prefill and the fused MLP: 300 positions, so that each
    # rank's one row still takes the W8A8 route (M > 256) as the whole
    # batch does
    ids = np.random.default_rng(2).integers(3, jcfg.vocab_size, (4, 300))
    switched = (np.asarray(jllama.embed_tokens(trees["int8"], jnp.asarray(ids))),
                np.broadcast_to(np.arange(300), (4, 300)).copy(),
                np.asarray([300, 297, 284, 300], np.int32), 3)
    for name in ("int8+w8a8", "int8+w8a8+fused"):
        gen_inputs[name] = switched
    # the shared-prefix prefill (row 6 on the card): the rows share their
    # first 3 embeddings
    emb, pos, lens, G = gen_inputs["f32"]
    emb = emb.copy()
    emb[:, :3] = emb[:1, :3]
    gen_inputs["f32+shared"] = (emb, pos, lens, G)
    # ChatGLM2's geometry (q/k/v biases, interleaved half rotary, 4 query
    # heads over 2 kv heads: one kv head a rank at tp 2) with a P-tuning
    # prefix of 4 positions
    gcfg = TCfg(**GLM)
    gtree = glm_params(JCfg(**GLM))
    grng = np.random.default_rng(5)
    gids = jnp.asarray(grng.integers(3, GLM["vocab_size"], (4, 7)))
    gprefix = tuple(grng.normal(size=(2, 1, 4, 2, 16)).astype(np.float32) for _ in range(2))
    gen_inputs["glm+ptuning"] = (gcfg, _np(gtree), (
        np.asarray(jllama.embed_tokens(gtree, gids)), np.broadcast_to(np.arange(7), (4, 7)).copy(),
        np.asarray([7, 5, 7, 6], np.int32), 4), gprefix)
    feats = np.random.default_rng(3).normal(size=(200, 32)).astype(np.float32)
    s1_jax, s1_port = engines(False, S1_EVAL)
    s1_kind = (s1_port.llama_cfg, s1_port.adapter_cfg, _np(s1_jax.params),
               _np(s1_jax.vision_params))
    s2_jax, s2_port = engines(True, S2_EVAL)
    surfaces = ((*s1_kind, TEval(**S1_EVAL)),
                (s2_port.llama_cfg, s2_port.adapter_cfg, _np(s2_jax.params),
                 _np(s2_jax.vision_params), TEval(**S2_EVAL)),
                np.load(root / "m1.npy"))
    case = ((tcfg, TAdapter(**ADAPTER), _np(params), _np(vision)), TEval(**ENGINE_EVAL), feats,
            "a red car")
    ranks = {}

    def port_side():
        try:
            ranks["out"] = run_ranks(serve_cases, 8, tcfg, {k: _np(v) for k, v in trees.items()},
                                     gen_inputs, case,
                                     (s1_kind, TEval(**S1_EVAL), _stage1_args(root, root / "mesh")),
                                     surfaces)
        except Exception as e:  # raised in the test's thread below
            ranks["error"] = e

    worker = threading.Thread(target=port_side)
    worker.start()
    mesh = jmesh.create_mesh(2, 2, 2)
    jax_out = {}
    for name, inputs in gen_inputs.items():
        if name.startswith("glm"):
            _, gtree, inputs, gprefix = inputs
            jax_out[name] = _jax_sharded_generate(JCfg(**GLM), mesh, gtree, inputs,
                                                  prefix=gprefix)
            continue
        jax_out[name] = _jax_sharded_generate(jcfg, mesh, trees[name.split("+")[0]], inputs,
                                              name.split("+")[1:])
    tok = JTok()
    for i in range(300):
        tok._id(str(i))
    jeng = JEngine(jcfg, JAdapter(**{**ADAPTER}), params, vision, tok, JEval(**ENGINE_EVAL),
                   mesh=mesh)
    with mesh:
        jax_out["engine"] = jeng.ground_windows(feats, "a red car")
    one = {"stage1": tstage1.run(argparse.Namespace(**_stage1_args(root, root / "one")), s1_port),
           "surfaces": engine_surfaces(None, *surfaces)}
    worker.join(timeout=300)
    if "error" in ranks:
        raise ranks["error"]
    assert not worker.is_alive(), "the port's ranks did not finish"
    return {"ranks": ranks["out"], "jax": jax_out, "one": one, "root": root}


@pytest.mark.parametrize("tree,tol", [("f32", 1e-5), ("int8", 1e-5), ("f32+shared", 1e-5),
                                      ("glm+ptuning", 1e-5), ("int8+w8a8", 1e-2),
                                      ("int8+w8a8+fused", 5e-2)])
def test_sharded_generate_matches_jax(served, tree, tol):
    """JAX's sharded generate: the tokens equal; for the f32 and int8
    trees, the shared-prefix prefill and ChatGLM2's geometry with a P-tuning
    prefix the values within 1e-5. Under the W8A8 prefill a row-parallel
    activation is quantized by its whole row's absmax, as in JAX's global
    program, so the int8 operands are the same; but a float difference far
    below 1e-5 (another summation order) can move an activation across an
    int8 rounding boundary, one step of 1/127 of its row's absmax: within
    1e-2 of the largest value. The fused MLP requantizes its output by each
    row's absmax over the F / tp columns a rank holds, where JAX's kernel
    takes the whole row: within the serving limit of 5e-2 (PERF.md
    section 2)."""
    want = served["jax"][tree]
    for r, out in enumerate(served["ranks"]):
        got = out["generate"][tree]
        np.testing.assert_array_equal(got["tokens"], want["tokens"], err_msg=f"rank {r}")
        np.testing.assert_array_equal(got["valid"], want["valid"])
        for k in ("entropy", "logprob", "prefill_logits"):
            scale = np.abs(want[k]).max()
            np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol * scale,
                                       err_msg=f"rank {r} {k}")


def test_engine_on_a_mesh_matches_jax(served):
    want = served["jax"]["engine"]
    for out in served["ranks"]:
        assert out["engine"]["answers"] == want["answers"]
        np.testing.assert_allclose(out["engine"]["scores_entropy"], want["scores_entropy"],
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("surface", ["batch", "caption", "retrieve", "retrieve_batch"])
def test_engine_surfaces_on_a_mesh_match_one_process(served, surface):
    """ground_windows_batch, caption_windows (stage-1 chunks of 4 rows: one
    a batch rank), retrieve and retrieve_batch (stage-2 row buckets, which
    (2, 2, 2)'s 4 batch ranks may not divide: every rank runs every row)
    give the one-process engine's answers, their scores within 1e-4."""
    want = served["one"]["surfaces"][surface]
    for out in served["ranks"]:
        got = out["surfaces"][surface]
        if surface == "caption":
            assert got == want
            continue
        for (ga, gs), (wa, ws) in zip(*(([x] if surface == "retrieve" else x)
                                        for x in (got, want))):
            assert ga == wa
            np.testing.assert_allclose(gs, ws, rtol=1e-4, atol=1e-5)


def test_stage1_rank0_alone_writes_the_one_process_file(served):
    """Every rank ran every query; the file holds each record once (one
    writer) and equals the one-process run's."""
    for out in served["ranks"]:
        assert out["stage1"]["done"] == served["one"]["stage1"]["done"] == 2
        assert out["stage1"]["errors"] == 0
    assert_records_equal(records(served["root"] / "one"), records(served["root"] / "mesh"),
                         {"scores"})


def _tiny_port(quantize):
    cfg = TCfg(**TINY)
    return cfg, tllama.init_params(cfg, seed=0, device="cpu", quantize=quantize)


def _inputs(cfg, params, B=2, T=5):
    ids = torch.arange(3, 3 + B * T).reshape(B, T)
    return (tllama.embed_tokens(params, ids), torch.arange(T).expand(B, T),
            torch.full((B,), T, dtype=torch.int32))


def test_megakernel_under_tensor_parallelism_raises(monkeypatch):
    """Row 9 holds whole layers in one launch: under tp it refuses before
    the prefill's first collective; under a data-only mesh the tree stays
    whole (the megakernel may run)."""
    cfg, params = _tiny_port(True)
    emb, pos, lens = _inputs(cfg, params)
    tp = fake_rank((1, 1, 2), 0)
    local = tserve.shard_params_for_inference(tp, params)
    monkeypatch.setattr(tgen, "_MEGAKERNEL", True)
    monkeypatch.setattr(tgen, "_KV8", True)
    with pytest.raises(ValueError, match="REVISIONLLM_MEGAKERNEL=1"):
        tgen.generate(cfg, local, emb, pos, lens, eos_id=2, max_new_tokens=2, mesh=tp)
    assert tserve.shard_params_for_inference(fake_rank((2, 1, 1), 1), params) is params


def test_packed_tree_under_sharding_raises():
    """Row 10's packed tree cannot be split over tensor or fsdp: the
    placement and generate refuse it; a data-only mesh keeps it whole."""
    cfg, params = _tiny_port(True)
    packed = {**params, "layers": TDSV.pack_serving_weights(params["layers"])}
    emb, pos, lens = _inputs(cfg, params)
    for shape in ((1, 1, 2), (1, 2, 1)):
        with pytest.raises(ValueError, match="serving-packed tree"):
            tserve.shard_params_for_inference(fake_rank(shape, 0), packed)
        with pytest.raises(ValueError, match="serving-packed tree"):
            tgen.generate(cfg, packed, emb, pos, lens, eos_id=2, max_new_tokens=2,
                          mesh=fake_rank(shape, 0))
    assert tserve.shard_params_for_inference(fake_rank((2, 1, 1), 0), packed) is packed


def test_int4_at_tp4_and_a_mesh_larger_than_the_world_raise(tmp_path):
    """Int4 down_proj rows that do not split into whole groups of 128
    refuse to shard; --mesh asks for more ranks than this one process."""
    cfg = TCfg(**{**TINY, "hidden_size": 256, "intermediate_size": 512, "num_heads": 2,
                  "num_kv_heads": 2, "head_dim": 128})
    params = tllama.init_params(cfg, seed=0, device="cpu", quantize="int4")
    assert tserve.shard_params_for_inference(fake_rank((1, 1, 2), 0), params) is not params
    with pytest.raises(ValueError, match="whole groups of 128"):
        tserve.shard_params_for_inference(fake_rank((1, 1, 4), 0), params)
    argv = ["--model_base", str(tmp_path / "missing"), "--data_path", "d.json",
            "--feat_folder", "f", "--log_path", str(tmp_path / "log"), "--device", "cpu",
            "--mesh", "2,2,2"]
    with pytest.raises(ValueError, match="needs 8 ranks, have 1"):
        tloader.build_engine_from_args(tstage1.parse_args(argv))
    assert not (tmp_path / "log").exists()
