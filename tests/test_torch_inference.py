"""Port parity for the single-call API (revisionllm_tpu_torch/inference.py:
inference, inference_stream) and models/generation.generate_stream against
the JAX package's, on one tiny f32 model (JAX's weights carried across) and
inputs from one numpy seed, on the CPU: the same answers, tokens equal,
per-step entropy within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revisionllm_tpu import inference as jinf
from revisionllm_tpu.config import AdapterConfig as JAdapter
from revisionllm_tpu.models import generation as jgen
from revisionllm_tpu.models import llama as jllama
from revisionllm_tpu.models import revisionllm as jrl
from revisionllm_tpu.utils.testing import FakeTokenizer as JTok
from revisionllm_tpu_torch import inference as tinf
from revisionllm_tpu_torch.config import AdapterConfig as TAdapter
from revisionllm_tpu_torch.models import generation as tgen
from revisionllm_tpu_torch.models import revisionllm as trl
from revisionllm_tpu_torch.models.multimodal import build_splice_plan, stack_plans
from revisionllm_tpu_torch.utils.testing import FakeTokenizer as TTok

from torch_parity import tiny_cfgs, to_torch

torch.set_num_threads(2)
ENT_TOL = dict(rtol=1e-5, atol=1e-5)


def _tok(cls):
    tok = cls()
    for i in range(300):
        tok._id(str(i))
    return tok


def _model(kind):
    """(JAX parts, port parts): cfg, adapter cfg, params, vision, tokenizer.
    `kind` "mlp" is the mlp projector, "clip" a ClipEncoder temporal
    adapter without T2V (tests/test_inference_api.py's two models)."""
    jcfg, tcfg = tiny_cfgs()
    kw = dict(d_model=16, num_heads=4, num_layers=2, ffn_dim=32, hidden_size=jcfg.hidden_size,
              clip_adapter_text=False, hierarchy=False, feature_mode="temporal",
              kind="mlp" if kind == "mlp" else "clip_encoder")
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    vision = jrl.init_vision_params(JAdapter(**kw), jax.random.PRNGKey(1), d_in=16)
    return ((jcfg, JAdapter(**kw), params, vision, _tok(JTok)),
            (tcfg, TAdapter(**kw), to_torch(params), to_torch(vision), _tok(TTok)))


@pytest.fixture(scope="module")
def models():
    return {k: _model(k) for k in ("mlp", "clip")}


def _feats(B, seed, T=8):
    return np.random.default_rng(seed).normal(size=(B, T, 16)).astype(np.float32)


def _same(jres, tres):
    (ja, jout), (ta, tout) = jres, tres
    assert ta == ja
    for k in ("tokens", "valid"):
        assert np.array_equal(tout[k].numpy(), np.asarray(jout[k])), k
    np.testing.assert_allclose(tout["entropy"].numpy(), np.asarray(jout["entropy"]), **ENT_TOL)
    np.testing.assert_allclose(tout["entropy_stats"].numpy(), np.asarray(jout["entropy_stats"]),
                               **ENT_TOL)


CASES = {
    "single": dict(B=1, query="<video>\nwhat is happening?", kw=dict(max_new_tokens=4)),
    "batch": dict(B=3, query="<video>\nwhere is the dog?",
                  kw=dict(max_new_tokens=3, return_list=True)),
    "history": dict(B=1, query="and then?",
                    kw=dict(max_new_tokens=3, history=[("<video>\nwhat happened?",
                                                        "From 01 to 02.")])),
    "memory": dict(B=2, query="<video>\ndid it happen before?", memory=(2, 16), prefix=True,
                   kw=dict(max_new_tokens=4, return_list=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_inference_matches_jax(models, case):
    """inference: a B = 1 string, a B > 1 list, a chat turn with history,
    the mlp memory path with prefix_memory_ids."""
    c = CASES[case]
    (jparts, tparts) = models["mlp"]
    image = _feats(c["B"], seed=len(case))
    extra = {}
    if "memory" in c:
        extra["visual_memory"] = np.random.default_rng(9).normal(size=c["memory"]).astype(
            np.float32)
    if c.get("prefix"):
        extra["prefix_memory_ids"] = np.asarray(jparts[4]("past memory context").input_ids,
                                                np.int32)
        assert list(extra["prefix_memory_ids"]) == tparts[4]("past memory context").input_ids
    jres = jinf.inference(*jparts, image, c["query"], **extra, **c["kw"])
    tres = tinf.inference(*tparts, image, c["query"], **extra, **c["kw"])
    _same(jres, tres)
    assert isinstance(tres[0], list if c["B"] > 1 else str)
    if "memory" in c:  # the memory block changes the decode
        plain = tinf.inference(*tparts, image, c["query"], **c["kw"])[1]
        assert not torch.equal(plain["entropy"], tres[1]["entropy"])


def test_inference_clip_memory_matches_jax(models):
    """A ClipEncoder adapter encodes the memory clip in dense temporal mode."""
    jparts, tparts = models["clip"]
    image = _feats(1, seed=11)
    mem = np.random.default_rng(12).normal(size=(1, 2, 16)).astype(np.float32)
    kw = dict(visual_memory=mem, max_new_tokens=4)
    _same(jinf.inference(*jparts, image, "<video>\nwhen", **kw),
          tinf.inference(*tparts, image, "<video>\nwhen", **kw))


@pytest.mark.parametrize("history", [None, [("<video>\nwhat happened?", "From 01 to 02.")]])
def test_inference_stream_matches_jax_and_inference(models, history, monkeypatch):
    """inference_stream yields JAX's strings; each one is the decode of the
    tokens streamed so far (stop string stripped), and the last equals
    inference's answer."""
    jparts, tparts = models["mlp"]
    image = _feats(1, seed=21)
    query = "<video>\nwhen does it happen" if history is None else "and then?"
    kw = dict(max_new_tokens=6, history=history)
    want = list(jinf.inference_stream(*jparts, image, query, **kw))

    streamed = []
    inner = tgen.generate_stream

    def spy(*a, **k):
        for t in inner(*a, **k):
            streamed.append(t)
            yield t

    monkeypatch.setattr(tgen, "generate_stream", spy)
    got = list(tinf.inference_stream(*tparts, image, query, **kw))
    assert got == want and got
    tok = tparts[4]
    for i, text in enumerate(got):
        full = tok.decode(streamed[: i + 1]).strip()
        assert text == (full[: -len("</s>")].strip() if full.endswith("</s>") else full)
    answer, out = tinf.inference(*tparts, image, query, **kw)
    assert got[-1] == answer
    n = int(out["valid"][0].sum())
    assert streamed == [t for t in out["tokens"][0, :n].tolist() if t != 2]


def _stream_inputs(jparts, tparts, seed):
    """(JAX, port) spliced embeddings, positions and lengths of one prompt."""
    ids = tinf._prompt_ids(tparts[4], "<video>\ndescribe it", None)
    image = _feats(1, seed)
    plan_np = stack_plans([build_splice_plan(ids, 8, len(ids) - 1 + 8 + 16)])
    jv = jrl.encode_video(jparts[1], jparts[3], jnp.asarray(image))
    jin = jrl.assemble_inputs(jparts[2], {k: jnp.asarray(v) for k, v in plan_np.items()}, jv,
                              dtype=jnp.float32)
    plan = {k: torch.as_tensor(v) for k, v in plan_np.items()}
    tv = trl.encode_video(tparts[1], tparts[3], torch.from_numpy(image))
    return jin, trl.assemble_inputs(tparts[2], plan, tv, dtype=torch.float32)


@pytest.mark.parametrize("eos_at", [None, 2])
def test_generate_stream_matches_jax_and_generate(models, eos_at):
    """generate_stream yields JAX's tokens and generate's greedy tokens, and
    stops at eos without yielding it (eos_at: the third greedy token is
    taken as the eos id)."""
    jparts, tparts = models["mlp"]
    jin, tin = _stream_inputs(jparts, tparts, seed=31)
    G = 7
    full = tgen.generate(tparts[0], tparts[2], *tin, eos_id=-1, max_new_tokens=G)
    greedy = full["tokens"][0].tolist()
    eos = -1 if eos_at is None else greedy[eos_at]
    want = list(jgen.generate_stream(jparts[0], jparts[2], *jin, eos_id=eos, max_new_tokens=G))
    got = list(tgen.generate_stream(tparts[0], tparts[2], *tin, eos_id=eos, max_new_tokens=G))
    assert got == want
    stop = greedy.index(eos) if eos in greedy else G
    assert got == greedy[:stop]
