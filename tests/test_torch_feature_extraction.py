"""Port parity: data/feature_extraction.py and demo.py's raw-video path
against revisionllm_tpu's on the CPU, on a tiny CLIP (a transformers
CLIPModel from a local config) and a tiny .y4m video.

The video and text extractors write RVFS stores whose records equal JAX's
within 1e-5 of their largest entry (f32 on both sides, sums in another
order); demo.load_video_features decodes, linspace-samples and encodes a
.y4m as JAX's does; demo.main --clip_path serves a raw video from a tiny HF
checkpoint, its REPL fed from stdin."""

import io
import os

import numpy as np
import pytest
import torch

from revisionllm_tpu import demo as jdemo
from revisionllm_tpu.data import feature_extraction as jfe
from revisionllm_tpu.data.video_reader import write_y4m
from revisionllm_tpu.models import clip as jclip
from revisionllm_tpu_torch import demo as tdemo
from revisionllm_tpu_torch.data import feature_extraction as tfe
from revisionllm_tpu_torch.data.feature_store import RvfsStore
from revisionllm_tpu_torch.models import clip as tclip

pytest.importorskip("transformers")
torch.set_num_threads(2)
TOL = 1e-5
PROJ = 16          # the CLIP projection: the demo's mlp projector reads 16-d features


def _clip_model(image_size):
    from transformers import CLIPConfig, CLIPModel

    cfg = CLIPConfig(
        text_config=dict(vocab_size=99, hidden_size=64, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=1,
                         max_position_embeddings=16, eos_token_id=98),
        vision_config=dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                           num_attention_heads=1, image_size=image_size,
                           patch_size=14 if image_size == 28 else 32),
        projection_dim=PROJ,
    )
    torch.manual_seed(0)
    return CLIPModel(cfg).eval()


@pytest.fixture(scope="module")
def clip_state():
    return {k: v.numpy() for k, v in _clip_model(28).state_dict().items()}


@pytest.fixture(scope="module")
def clip224():
    """The demo's geometry: 224 px crops (patch 32)."""
    return _clip_model(224)


def tokenize(texts):
    """A toy tokenizer: character ids, then EOT (98), zero padding."""
    out = np.zeros((len(texts), 8), np.int64)
    for i, t in enumerate(texts):
        ids = [min(ord(c) % 90 + 3, 97) for c in t[:6]]
        out[i, : len(ids)] = ids
        out[i, len(ids)] = 98
    return out


def _video(path, t=30, h=40, w=56, fps=10.0, seed=0):
    frames = np.random.default_rng(seed).integers(0, 256, size=(t, h, w, 3), dtype=np.uint8)
    write_y4m(path, frames, fps=fps)
    return path


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def _stores_close(a, b):
    sa, sb = RvfsStore(a), RvfsStore(b)
    assert sorted(sa.keys()) == sorted(sb.keys())
    for k in sb.keys():
        ra, rb = sa.get_record(k), sb.get_record(k)
        assert set(ra) == set(rb)
        for name in rb:
            _close(ra[name], rb[name])


def test_helpers_match_jax():
    frames = np.random.default_rng(2).integers(0, 256, size=(7, 8, 8, 3), dtype=np.uint8)
    got = tfe.preprocess_frames(frames)
    assert got.shape == (7, 3, 8, 8) and got.dtype == np.float32
    assert np.array_equal(got, jfe.preprocess_frames(frames))
    for n in (3, 7, 20):
        assert np.array_equal(tfe.linspace_sample(frames, n), jfe.linspace_sample(frames, n))
    assert tfe.ffmpeg_available() == jfe.ffmpeg_available()


def test_video_extractor_matches_jax(clip_state, tmp_path):
    """Two videos at 5 fps into one store; batch 4 leaves a partial last
    batch, which the port runs at its own size."""
    videos = {"a": _video(str(tmp_path / "a.y4m")), "b": _video(str(tmp_path / "b.y4m"), t=23,
                                                               seed=1)}
    tex = tfe.ClipFeatureExtractor(tclip.convert_hf_clip(clip_state), batch_size=4, device="cpu")
    jex = jfe.ClipFeatureExtractor(jclip.convert_hf_clip(clip_state), batch_size=4)
    out_t, out_j = str(tmp_path / "port.rvfs"), str(tmp_path / "jax.rvfs")
    assert tfe.extract_video_features(tex, videos, out_t, target_fps=5.0, size=28) == 2
    jfe.extract_video_features(jex, videos, out_j, target_fps=5.0, size=28)
    assert RvfsStore(out_t).get("a").shape == (15, PROJ)
    _stores_close(out_t, out_j)


def test_text_extractor_matches_jax(clip_state, tmp_path):
    queries = {"q1": "hello", "q2": "a dog", "q3": "x", "q4": "runs far", "q5": "the end"}
    tex = tfe.ClipFeatureExtractor(tclip.convert_hf_clip(clip_state), device="cpu")
    jex = jfe.ClipFeatureExtractor(jclip.convert_hf_clip(clip_state), batch_size=4)
    out_t, out_j = str(tmp_path / "port.rvfs"), str(tmp_path / "jax.rvfs")
    for trim in (True, False):
        assert tfe.extract_text_features(tex, queries, tokenize, out_t, trim_to_eot=trim,
                                         batch_size=2) == 5
        jfe.extract_text_features(jex, queries, tokenize, out_j, trim_to_eot=trim, batch_size=2)
        _stores_close(out_t, out_j)
        rec = RvfsStore(out_t).get_record("q3")
        assert rec["token_features"].shape == ((2 if trim else 8), PROJ)


def test_load_video_features_on_a_y4m(clip224, tmp_path):
    """Decoded at 1 fps (12 frames), linspace-sampled to 8 and encoded, as
    JAX's demo.load_video_features; without an extractor it raises."""
    path = _video(str(tmp_path / "v.y4m"), t=120, fps=10.0)
    state = {k: v.numpy() for k, v in clip224.state_dict().items()}
    tex = tfe.ClipFeatureExtractor(tclip.convert_hf_clip(state), device="cpu")
    jex = jfe.ClipFeatureExtractor(jclip.convert_hf_clip(state), batch_size=8)
    got = tdemo.load_video_features(path, tex, num_frames=8)
    want = jdemo.load_video_features(path, jex, num_frames=8)
    assert got.shape == (8, PROJ)
    _close(got, want)
    with pytest.raises(RuntimeError, match="CLIP extractor"):
        tdemo.load_video_features(path)


@pytest.fixture(scope="module")
def demo_dirs(tmp_path_factory, clip224):
    """A tiny HF Llama (hidden 64), an mlp projector from 16-d features, a
    tiny HF CLIP directory at 224 px (patch 32), and a 6 s .y4m."""
    from revisionllm_tpu_torch.config import AdapterConfig
    from revisionllm_tpu_torch.data.synthetic import build_tiny_hf_checkpoint
    from revisionllm_tpu_torch.models import revisionllm as trl
    from revisionllm_tpu_torch.train.checkpoint import export_reference_artifacts

    root = tmp_path_factory.mktemp("demo")
    hf = build_tiny_hf_checkpoint(str(root / "hf"), hidden_size=64, num_layers=2,
                                  intermediate_size=128)
    vision = trl.init_vision_params(AdapterConfig(kind="mlp", hidden_size=64), seed=3, d_in=PROJ,
                                    device="cpu")
    export_reference_artifacts(str(root / "proj"), None, None, vision)
    clip224.save_pretrained(str(root / "clip"))
    return {"hf": hf, "proj": str(root / "proj" / "non_lora_trainables.bin"),
            "clip": str(root / "clip"),
            "video": _video(str(root / "v.y4m"), t=60, h=240, w=320, fps=10.0)}


def test_demo_main_from_a_raw_video(demo_dirs, monkeypatch, capsys):
    """demo.main --clip_path --device cpu on a .y4m: the REPL streams two
    answers, equal to a ChatSession's over load_model's parts and the
    features an extractor of the same CLIP directory gives."""
    from revisionllm_tpu_torch.eval.loader import load_model
    from revisionllm_tpu_torch.models.convert import load_hf_llama_state

    d = demo_dirs
    argv = ["--model_base", d["hf"], "--pretrain_mm_mlp_adapter", d["proj"], "--video",
            d["video"], "--clip_path", d["clip"], "--device", "cpu"]
    monkeypatch.delenv("REVISIONLLM_QUANT", raising=False)
    monkeypatch.setattr("sys.stdin", io.StringIO("when does the video start\nand then\n\n"))
    tdemo.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("video loaded")
    answers = [line.split("assistant> ", 1)[1] for line in out if "assistant> " in line]
    assert len(answers) == 2

    ex = tfe.ClipFeatureExtractor(tclip.convert_hf_clip(load_hf_llama_state(d["clip"])),
                                  device="cpu")
    feats = tdemo.load_video_features(d["video"], ex)
    assert feats.shape == (100, PROJ) and np.isfinite(feats).all()
    session = tdemo.ChatSession(load_model(tdemo.parse_args(argv))[:5], feats)
    assert answers == [session.ask("when does the video start"), session.ask("and then")]
    assert os.path.isfile(os.path.join(d["clip"], "config.json"))
