"""Port parity for the stage-1 slice as a whole: eval/engine.py
ground_windows, its scoring tail, the adapter, splicing and the host
planning copies, against revisionllm_tpu on the CPU (f32)."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revisionllm_tpu.config import AdapterConfig as JAdapter
from revisionllm_tpu.config import EvalConfig as JEval
from revisionllm_tpu.eval.engine import GroundingEngine as JEngine
from revisionllm_tpu.models import llama as jllama
from revisionllm_tpu.models import multimodal as jmm
from revisionllm_tpu.models import revisionllm as jrl
from revisionllm_tpu.ops import windows as jwin
from revisionllm_tpu.utils.testing import FakeTokenizer as JTok
from revisionllm_tpu_torch.config import AdapterConfig as TAdapter
from revisionllm_tpu_torch.config import EvalConfig as TEval
from revisionllm_tpu_torch.eval.engine import GroundingEngine as TEngine
from revisionllm_tpu_torch.models import multimodal as tmm
from revisionllm_tpu_torch.models import revisionllm as trl
from revisionllm_tpu_torch.ops import windows as twin
from revisionllm_tpu_torch.utils.testing import FakeTokenizer as TTok

from torch_parity import np_of, tiny_cfgs, to_torch

torch.set_num_threads(2)


def _adapter_kw(hidden, **kw):
    return {**dict(d_model=16, num_heads=4, num_layers=2, ffn_dim=32, hidden_size=hidden,
                   clip_adapter_text=True, hierarchy=False, feature_mode="temporal"), **kw}


def _engines(kv_heads=4, **ecfg_kw):
    """The tests/test_engine_batch.py engine (tiny f32 Llama, ClipEncoder
    temporal adapter, FakeTokenizer) in both packages, on JAX's weights."""
    jcfg, tcfg = tiny_cfgs(kv_heads)
    kw = _adapter_kw(jcfg.hidden_size)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    vision = jrl.init_vision_params(JAdapter(**kw), jax.random.PRNGKey(1), d_in=16)
    ekw = dict(debug_window=20, num_frames=16, feature_fps=2.0, batch=4, stride=2,
               max_new_tokens=6, **ecfg_kw)
    engines = []
    for Engine, Adapter, Eval, Tok, cfg, p, v, extra in (
        (JEngine, JAdapter, JEval, JTok, jcfg, params, vision, {}),
        (TEngine, TAdapter, TEval, TTok, tcfg, to_torch(params), to_torch(vision), {"device": "cpu"}),
    ):
        tok = Tok()
        for i in range(300):
            tok._id(str(i))
        engines.append(Engine(cfg, Adapter(**kw), p, v, tok, Eval(**ekw), **extra))
    return engines


@pytest.fixture(scope="module")
def query():
    rng = np.random.default_rng(0)
    movie = rng.normal(size=(400, 16)).astype(np.float32)
    qf = rng.normal(size=(3, 16)).astype(np.float32)
    qc = rng.normal(size=(16,)).astype(np.float32)
    return movie, qf, qc / np.linalg.norm(qc)


def _assert_stage1_equal(want, got):
    """Identical answers and proposal frames; scores within rtol 1e-4 (as
    tests/test_engine_batch.py holds the batched path to the sequential)."""
    assert got["answers"] == want["answers"]
    assert got["frames"] == want["frames"]
    assert got["num_windows"] == want["num_windows"]
    for k in ("scores", "scores_entropy", "score_cos"):
        np.testing.assert_allclose(np.asarray(got[k], np.float64), np.asarray(want[k], np.float64),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
def test_ground_windows_matches_jax(query, kv_heads):
    movie, qf, qc = query
    jeng, teng = _engines(kv_heads)
    want = jeng.ground_windows(movie, "a red car drives by.", qf, qc)
    got = teng.ground_windows(movie, "a red car drives by.", qf, qc, movie_key="m")
    assert got["num_windows"] == 19 and len(got["answers"]) == 19  # 5 chunks, tail padded
    _assert_stage1_equal(want, got)
    again = teng.ground_windows(movie, "a red car drives by.", qf, qc, movie_key="m")
    _assert_stage1_equal(got, again)  # the cached device movie serves the repeat


@pytest.mark.parametrize("exact_cosine", ["0", "1"])
def test_stage1_finalize_scoring_matches_jax(query, exact_cosine, monkeypatch):
    """The proposal-scoring tail on answers that parse (random tiny models
    rarely answer "From X to Y"): parsed frames, CLIP cosine (both the
    per-frame norm and the REVISIONLLM_EXACT_COSINE quirk), normalization
    and the multiply merge."""
    monkeypatch.setenv("REVISIONLLM_EXACT_COSINE", exact_cosine)
    movie, _, qc = query
    jeng, teng = _engines()
    plan_idx = teng._stage1_plan_idx(len(movie))
    np.testing.assert_array_equal(plan_idx, jeng._stage1_plan_idx(len(movie)))
    n = len(plan_idx)
    answers = ["From 3 to 7.", "Not Present", "From 0 to 15", "2 and 9", "From 15 to 15"] * 4
    answers = answers[:n]
    ent = list(np.linspace(0.5, 2.0, n))
    want = jeng._stage1_finalize(answers, ent, plan_idx, movie, None,
                                 jeng._features_to_device(movie), qc, time.time())
    got = teng._stage1_finalize(answers, ent, plan_idx, teng._features_to_device(movie), qc)
    assert len(got["score_cos"]) == len(got["frames"]) > 0
    _assert_stage1_equal(want, got)


@pytest.mark.parametrize("mode", ["temporal", "cls"])
@pytest.mark.parametrize("with_text", [True, False])
def test_encode_video_matches_jax(mode, with_text):
    """The ClipEncoder adapter in f32 (rtol/atol 1e-5)."""
    kw = _adapter_kw(32, feature_mode=mode)
    jv = jrl.init_vision_params(JAdapter(**kw), jax.random.PRNGKey(3), d_in=16)
    rng = np.random.default_rng(1)
    images = rng.normal(size=(3, 10, 16)).astype(np.float32)
    text = rng.normal(size=(3, 4, 16)).astype(np.float32) if with_text else None
    tvalid = np.asarray([[1, 1, 1, 1], [1, 1, 0, 0], [1, 0, 0, 0]], bool) if with_text else None
    want = jrl.encode_video(JAdapter(**kw), jv, jnp.asarray(images),
                            None if text is None else jnp.asarray(text),
                            None if tvalid is None else jnp.asarray(tvalid))
    got = trl.encode_video(TAdapter(**kw), to_torch(jv), torch.from_numpy(images),
                           None if text is None else torch.from_numpy(text),
                           None if tvalid is None else torch.from_numpy(tvalid))
    assert got.shape == want.shape
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=1e-5, atol=1e-5)


def test_splice_and_assemble_match_jax():
    ids = [1, 5, 6, -200, 7, 8, -300, 9]
    jplan = jmm.stack_plans([jmm.build_splice_plan(ids, 4, 16, num_memory_tokens=2)] * 2)
    tplan = tmm.stack_plans([tmm.build_splice_plan(ids, 4, 16, num_memory_tokens=2)] * 2)
    for k in jplan:
        np.testing.assert_array_equal(tplan[k], jplan[k], err_msg=k)
    jcfg, _ = tiny_cfgs()
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.default_rng(2)
    video = rng.normal(size=(2, 4, jcfg.hidden_size)).astype(np.float32)
    memory = rng.normal(size=(2, 2, jcfg.hidden_size)).astype(np.float32)
    want = jrl.assemble_inputs(params, {k: jnp.asarray(v) for k, v in jplan.items()},
                               jnp.asarray(video), jnp.asarray(memory))
    got = trl.assemble_inputs(to_torch(params), {k: torch.as_tensor(v) for k, v in tplan.items()},
                              torch.from_numpy(video), torch.from_numpy(memory))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np_of(g), np_of(w))


@pytest.mark.parametrize("ctx,clip", [(18000, 625), (400, 40), (30, 40)])
def test_window_planning_matches_jax(ctx, clip):
    jb = jwin.dense_window_bounds(ctx, clip)
    assert twin.dense_window_bounds(ctx, clip) == jb
    np.testing.assert_array_equal(twin.window_frame_indices(jb, 250), jwin.window_frame_indices(jb, 250))
    feats = np.arange(ctx * 2, dtype=np.float32).reshape(ctx, 2)
    idx = twin.window_frame_indices(jb, 8)
    if len(jb):
        np.testing.assert_array_equal(
            twin.gather_windows(torch.from_numpy(feats), idx).numpy(),
            np.asarray(jwin.gather_windows(jnp.asarray(feats), idx)),
        )


@pytest.mark.parametrize("variant", [{"baseline": True}, {"plus_baseline": True}])
def test_plan_variants_match_jax(variant):
    jeng, teng = _engines(**variant)
    for ctx in (400, 37):
        np.testing.assert_array_equal(teng._stage1_plan_idx(ctx), jeng._stage1_plan_idx(ctx))
