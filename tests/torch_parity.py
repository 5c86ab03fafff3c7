"""Shared helpers for the port's parity tests (tests/test_torch_*.py): one
seed, numpy inputs, both packages, tensors on the CPU."""

import json
import os

import jax
import numpy as np
import torch

from revisionllm_tpu_torch.models.weights import params_from_numpy

CPU = torch.device("cpu")


def to_torch(tree, dtype=None):
    """A JAX parameter tree -> the port's tree of CPU tensors."""
    return params_from_numpy(jax.tree.map(np.asarray, tree), CPU, dtype)


def np_of(t):
    """torch tensor or JAX array -> float64 numpy (for comparisons)."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy().astype(np.float64)
    return np.asarray(t, dtype=np.float64)


def tiny_cfgs(num_kv_heads=4, vocab_size=512):
    """The same tiny f32 Llama geometry in both packages' config classes."""
    from revisionllm_tpu.config import LlamaConfig as JCfg
    from revisionllm_tpu_torch.config import LlamaConfig as TCfg

    kw = {**JCfg.tiny(vocab_size).__dict__, "dtype": "float32", "num_kv_heads": num_kv_heads}
    return JCfg(**kw), TCfg(**kw)


S1_EVAL = dict(debug_window=20, num_frames=16, feature_fps=2.0, batch=4, stride=2,
               max_new_tokens=6)


def adapter_kw(hidden, hierarchy=False, **kw):
    """A narrow ClipEncoder T2V adapter: temporal, or hierarchy cls."""
    return {**dict(d_model=16, num_heads=4, num_layers=2, ffn_dim=32, hidden_size=hidden,
                   clip_adapter_text=True, hierarchy=hierarchy,
                   feature_mode="cls" if hierarchy else "temporal"), **kw}


def engines(hierarchy=False, ecfg_kw=S1_EVAL, kv_heads=4, quantize=None):
    """The tests/test_engine_batch.py engine (tiny f32 Llama, ClipEncoder
    adapter, FakeTokenizer with the numbers 0-299) in both packages, on
    JAX's weights, transformed by the JAX function `quantize` when given
    (e.g. quantize_llama_params_int4): (JAX engine, port engine on the
    CPU)."""
    import jax.numpy as jnp

    from revisionllm_tpu.config import AdapterConfig as JAdapter
    from revisionllm_tpu.config import EvalConfig as JEval
    from revisionllm_tpu.eval.engine import GroundingEngine as JEngine
    from revisionllm_tpu.models import llama as jllama
    from revisionllm_tpu.models import revisionllm as jrl
    from revisionllm_tpu.utils.testing import FakeTokenizer as JTok
    from revisionllm_tpu_torch.config import AdapterConfig as TAdapter
    from revisionllm_tpu_torch.config import EvalConfig as TEval
    from revisionllm_tpu_torch.eval.engine import GroundingEngine as TEngine
    from revisionllm_tpu_torch.utils.testing import FakeTokenizer as TTok

    jcfg, tcfg = tiny_cfgs(kv_heads)
    kw = adapter_kw(jcfg.hidden_size, hierarchy)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    if quantize is not None:
        params = quantize(params)
    vision = jrl.init_vision_params(JAdapter(**kw), jax.random.PRNGKey(1), d_in=16)
    out = []
    for Engine, Adapter, Eval, Tok, cfg, p, v, extra in (
        (JEngine, JAdapter, JEval, JTok, jcfg, params, vision, {}),
        (TEngine, TAdapter, TEval, TTok, tcfg, to_torch(params), to_torch(vision),
         {"device": "cpu"}),
    ):
        tok = Tok()
        for i in range(300):
            tok._id(str(i))
        out.append(Engine(cfg, Adapter(**kw), p, v, tok, Eval(**ecfg_kw), **extra))
    return out


def assert_stage1_equal(want, got):
    """Identical answers and proposal frames; scores within rtol 1e-4 (as
    tests/test_engine_batch.py holds the batched path to the sequential)."""
    assert got["answers"] == want["answers"]
    assert got["frames"] == want["frames"]
    assert got["num_windows"] == want["num_windows"]
    for k in ("scores", "scores_entropy", "score_cos"):
        np.testing.assert_allclose(np.asarray(got[k], np.float64), np.asarray(want[k], np.float64),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def records(path):
    """The JSONL records of split 0 of an eval CLI's log directory."""
    with open(os.path.join(path, "predictions_streaming_0.txt")) as f:
        return [json.loads(line) for line in f]


def assert_records_equal(want, got, float_keys):
    """The same records: every field equal, the `float_keys` of "info"
    within rtol 1e-4."""
    assert len(got) == len(want) > 0
    for w, g in zip(want, got):
        assert {k: v for k, v in g.items() if k != "info"} == \
            {k: v for k, v in w.items() if k != "info"}
        assert set(g["info"]) == set(w["info"])
        for k in w["info"]:
            if k in float_keys:
                np.testing.assert_allclose(np.asarray(g["info"][k], np.float64),
                                           np.asarray(w["info"][k], np.float64),
                                           rtol=1e-4, atol=1e-5, err_msg=k)
            else:
                assert g["info"][k] == w["info"][k], k
