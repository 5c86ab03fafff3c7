"""Port parity for the demo surfaces: revisionllm_tpu_torch/demo.py
(ChatSession.ask / ask_stream against the JAX package's ChatSession on one
tiny f32 model: the same answers, turn by turn; demo.main from a tiny HF
checkpoint with --device cpu and its REPL fed from stdin) and webdemo.py
(the HTTP routes of tests/test_webdemo.py, over real sockets on the
loopback, and a real session whose streamed answers equal ChatSession.ask)."""

import io
import json
import sys
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from revisionllm_tpu import demo as jdemo
from revisionllm_tpu.config import AdapterConfig as JAdapter
from revisionllm_tpu.models import llama as jllama
from revisionllm_tpu.models import revisionllm as jrl
from revisionllm_tpu.utils.testing import FakeTokenizer as JTok
from revisionllm_tpu_torch import demo as tdemo
from revisionllm_tpu_torch.config import AdapterConfig as TAdapter
from revisionllm_tpu_torch.utils.testing import FakeTokenizer as TTok
from revisionllm_tpu_torch.webdemo import DemoServer

from torch_parity import tiny_cfgs, to_torch

torch.set_num_threads(2)
TURNS = ["when does it happen?", "and after that?", "who is there?"]


def _tok(cls):
    tok = cls()
    for i in range(300):
        tok._id(str(i))
    return tok


@pytest.fixture(scope="module")
def parts():
    """(JAX, port) engine parts of tests/test_webdemo.py's tiny mlp model."""
    jcfg, tcfg = tiny_cfgs()
    kw = dict(d_model=16, num_heads=4, num_layers=2, ffn_dim=32, hidden_size=jcfg.hidden_size,
              clip_adapter_text=False, hierarchy=False, feature_mode="temporal", kind="mlp")
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    vision = jrl.init_vision_params(JAdapter(**kw), jax.random.PRNGKey(1), d_in=16)
    return ((jcfg, JAdapter(**kw), params, vision),
            (tcfg, TAdapter(**kw), to_torch(params), to_torch(vision)))


def _feats(tmp_path, seed=0, T=40):
    p = tmp_path / "feats.npy"
    np.save(p, np.random.default_rng(seed).normal(size=(T, 16)).astype(np.float32))
    return str(p)


@pytest.mark.parametrize("stream", [False, True], ids=["ask", "ask_stream"])
def test_chat_session_matches_jax(parts, tmp_path, stream):
    """Three turns: the first carries <video>, the later ones the history;
    equal answers and histories on both sides (max_new_tokens 5)."""
    path = _feats(tmp_path)
    feats = tdemo.load_video_features(path, num_frames=8)
    assert np.array_equal(feats, jdemo.load_video_features(path, num_frames=8))
    js = jdemo.ChatSession((*parts[0], _tok(JTok)), feats, max_new_tokens=5)
    ts = tdemo.ChatSession((*parts[1], _tok(TTok)), feats, max_new_tokens=5)
    for q in TURNS:
        if stream:
            want, got = list(js.ask_stream(q)), list(ts.ask_stream(q))
            assert got == want and got
        else:
            assert ts.ask(q) == js.ask(q)
    assert ts.history == js.history and len(ts.history) == 3
    assert ts.history[0][0].startswith("<video>\n") and not ts.history[1][0].startswith("<")


def test_raw_video_waits_for_clip(tmp_path, monkeypatch):
    """The raw-video path: a tiny .y4m decoded at 1 fps, linspace-sampled
    and encoded by an extractor gives the features JAX's
    load_video_features gives with the same extractor; an mp4 where no
    ffmpeg is found raises JAX's own error, on both sides."""
    from revisionllm_tpu.data import feature_extraction as jfe
    from revisionllm_tpu.data.video_reader import write_y4m
    from revisionllm_tpu_torch.data import feature_extraction as tfe

    class PixelMeans:
        """A stand-in for the CLIP extractor: 16 means of each frame's pixels."""

        def encode_images(self, pixels):
            return pixels.reshape(len(pixels), 16, -1).mean(-1)

    path = str(tmp_path / "clip.y4m")
    frames = np.random.default_rng(4).integers(0, 256, size=(50, 60, 80, 3), dtype=np.uint8)
    write_y4m(path, frames, fps=10.0)
    got = tdemo.load_video_features(path, PixelMeans(), num_frames=8)
    assert got.shape == (8, 16) and np.isfinite(got).all()
    assert np.array_equal(got, jdemo.load_video_features(path, PixelMeans(), num_frames=8))
    for mod in (tfe, jfe):
        monkeypatch.setattr(mod, "ffmpeg_available", lambda: False)
    for load in (tdemo.load_video_features, jdemo.load_video_features):
        with pytest.raises(RuntimeError, match="ffmpeg not available and input is not .y4m"):
            load(str(tmp_path / "clip.mp4"), PixelMeans())


def test_gradio_absent_returns_none(capsys, monkeypatch):
    """Without gradio (its import made to fail), launch_gradio says so and
    returns None, as JAX's does."""
    monkeypatch.setitem(sys.modules, "gradio", None)
    assert tdemo.launch_gradio(lambda p: None) is None
    assert "gradio is not installed" in capsys.readouterr().err


def test_main_repl_from_stdin(tmp_path, monkeypatch, capsys):
    """demo.main on a tiny HF checkpoint and an exported mlp projector, with
    --device cpu: the REPL reads two questions and an empty line from stdin,
    streams each answer, and the transcript holds the answers a ChatSession
    over eval.loader.load_model's parts gives."""
    pytest.importorskip("transformers")
    from revisionllm_tpu_torch.data.synthetic import build_tiny_hf_checkpoint
    from revisionllm_tpu_torch.eval.loader import load_model
    from revisionllm_tpu_torch.models import revisionllm as trl
    from revisionllm_tpu_torch.train.checkpoint import export_reference_artifacts

    hf = build_tiny_hf_checkpoint(str(tmp_path / "hf"), hidden_size=64, num_layers=2,
                                  intermediate_size=128)
    vision = trl.init_vision_params(TAdapter(kind="mlp", hidden_size=64), seed=3, d_in=16,
                                    device="cpu")
    export_reference_artifacts(str(tmp_path / "proj"), None, None, vision)
    argv = ["--model_base", hf, "--pretrain_mm_mlp_adapter",
            str(tmp_path / "proj" / "non_lora_trainables.bin"), "--video",
            _feats(tmp_path, T=120), "--device", "cpu"]
    monkeypatch.delenv("REVISIONLLM_QUANT", raising=False)
    monkeypatch.setattr("sys.stdin", io.StringIO("when does the video start\nand then\n\n"))
    tdemo.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("video loaded")
    answers = [line.split("assistant> ", 1)[1] for line in out if "assistant> " in line]
    assert len(answers) == 2

    args = tdemo.parse_args(argv)
    session = tdemo.ChatSession(load_model(args)[:5], tdemo.load_video_features(args.video))
    assert session.params["embed"].device.type == "cpu"
    assert answers == [session.ask("when does the video start"), session.ask("and then")]


# ------------------------------------------------------------------ webdemo


class StubSession:
    """A ChatSession lookalike that streams a canned answer."""

    def __init__(self, path: str):
        self.path = path
        self.history = []

    def ask_stream(self, question: str):
        answer = ""
        for word in ("the", "event", "happens", "early"):
            answer = (answer + " " + word).strip()
            yield answer
        self.history.append((question, answer))


def _serve(make_session):
    srv = DemoServer(make_session, host="127.0.0.1", port=0)
    srv.start_background()
    return srv


@pytest.fixture()
def server():
    made = []

    def make_session(path):
        made.append(StubSession(path))
        return made[-1]

    srv = _serve(make_session)
    try:
        yield srv, made
    finally:
        srv.shutdown()


def _get(port, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30)


def _post(port, path, data=b""):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method="POST")
    return urllib.request.urlopen(req, timeout=30)


def _answer(port, q):
    """The SSE events of /api/ask: the growing answers, then [DONE]."""
    events = [line.decode().strip()[6:] for line in _get(port, f"/api/ask?q={q}")
              if line.startswith(b"data: ")]
    assert events[-1] == "[DONE]"
    return [json.loads(e) for e in events[:-1]]


def test_webdemo_routes(server, tmp_path):
    """index; 409 before a video; upload then a streamed answer; reset;
    a second upload replaces the session."""
    srv, made = server
    body = _get(srv.port, "/").read().decode()
    assert "ReVisionLLM" in body and "EventSource" in body
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(srv.port, "/api/ask?q=hello")
    assert e.value.code == 409
    path = _feats(tmp_path)
    with open(path, "rb") as f:
        data = f.read()
    r = _post(srv.port, "/api/video?name=feats.npy", data)
    assert json.loads(r.read())["status"].startswith("video processed")
    assert len(made) == 1 and made[0].path.endswith(".npy")
    partials = _answer(srv.port, "when")
    assert partials[-1] == "the event happens early"
    assert all(b.startswith(a) for a, b in zip(partials, partials[1:]))
    assert made[0].history == [("when", "the event happens early")]
    _post(srv.port, "/api/reset")
    assert made[0].history == []
    _post(srv.port, "/api/video?name=feats.npy", data)
    assert len(made) == 2


def test_webdemo_bad_upload_is_500():
    def broken(path):
        raise ValueError("no decoder for this container")

    srv = _serve(broken)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.port, "/api/video?name=x.mp4", b"\x00\x01")
        assert e.value.code == 500
        assert "no decoder" in json.loads(e.value.read())["error"]
    finally:
        srv.shutdown()


def test_webdemo_real_session_equals_ask(parts, tmp_path):
    """DemoServer over a port ChatSession: two turns asked over HTTP stream
    the answers a fresh ChatSession.ask gives, the second with history."""
    tparts = parts[1]
    sessions = []

    def make_session(path):
        sessions.append(tdemo.ChatSession((*tparts, _tok(TTok)),
                                          tdemo.load_video_features(path, num_frames=8),
                                          max_new_tokens=4))
        return sessions[-1]

    srv = _serve(make_session)
    try:
        path = _feats(tmp_path, seed=5)
        with open(path, "rb") as f:
            _post(srv.port, "/api/video?name=f.npy", f.read())
        streamed = [_answer(srv.port, "when+is+it")[-1], _answer(srv.port, "and+then")[-1]]
    finally:
        srv.shutdown()
    fresh = tdemo.ChatSession((*tparts, _tok(TTok)), tdemo.load_video_features(path, num_frames=8),
                              max_new_tokens=4)
    assert streamed == [fresh.ask("when is it"), fresh.ask("and then")]
    assert sessions[0].history == fresh.history
