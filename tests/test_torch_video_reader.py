"""Port parity: data/video_reader.py (the pure-python .y4m path) against
revisionllm_tpu's on the same frames: the writers' bytes, the readers'
frames and fps (C444, a hand-built C420 and a fractional rate),
resample_fps, the scale-and-crop, decode_frames_py, and VideoExtractor's
four sampling modes, all equal exactly."""

import numpy as np
import pytest

from revisionllm_tpu.data import video_reader as jvr
from revisionllm_tpu_torch.data import video_reader as tvr


def _frames(t=12, h=48, w=64, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(t, h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("fps", [25.0, 23.976])
def test_y4m_round_trip_matches_jax(tmp_path, fps):
    frames = _frames()
    a, b = str(tmp_path / "port.y4m"), str(tmp_path / "jax.y4m")
    tvr.write_y4m(a, frames, fps=fps)
    jvr.write_y4m(b, frames, fps=fps)
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()
    got, got_fps = tvr.read_y4m(a)
    want, want_fps = jvr.read_y4m(a)
    assert got_fps == want_fps and abs(got_fps - fps) < 1e-6
    assert got.shape == frames.shape and np.array_equal(got, want)
    # the BT.601 matrix round trip: a few levels
    assert np.abs(got.astype(int) - frames.astype(int)).max() <= 4


def test_c420_and_bad_magic(tmp_path):
    h, w = 16, 24
    rng = np.random.default_rng(1)
    p = tmp_path / "c420.y4m"
    with open(p, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F30:1 C420jpeg\n".encode())
        for _ in range(3):
            f.write(b"FRAME\n" + rng.integers(0, 256, h * w * 3 // 2, dtype=np.uint8).tobytes())
    got, want = tvr.read_y4m(str(p)), jvr.read_y4m(str(p))
    assert got[1] == want[1] == 30.0 and np.array_equal(got[0], want[0])
    bad = tmp_path / "bad.y4m"
    bad.write_bytes(b"NOTY4M W2 H2\nFRAME\n\x00\x00\x00\x00")
    with pytest.raises(ValueError, match="not a YUV4MPEG2"):
        tvr.read_y4m(str(bad))


@pytest.mark.parametrize("n,src,target", [(100, 25.0, 5.0), (30, 10.0, 10.0), (1500, 25.0, 1.0),
                                          (7, 30.0, 2.0)])
def test_resample_fps_matches_jax(n, src, target):
    assert np.array_equal(tvr.resample_fps(n, src, target), jvr.resample_fps(n, src, target))


@pytest.mark.parametrize("h,w,size", [(48, 96, 32), (96, 48, 24), (240, 320, 224), (31, 47, 16)])
def test_scale_center_crop_matches_jax(h, w, size):
    frames = _frames(t=2, h=h, w=w, seed=h)
    got = tvr.scale_shorter_center_crop(frames, size)
    assert got.shape == (2, size, size, 3)
    assert np.array_equal(got, jvr.scale_shorter_center_crop(frames, size))


def test_decode_frames_py_matches_jax(tmp_path):
    p = str(tmp_path / "v.y4m")
    tvr.write_y4m(p, _frames(t=40, h=36, w=60), fps=20.0)
    got = tvr.decode_frames_py(p, target_fps=5.0, size=28)
    assert got.shape == (10, 28, 28, 3) and got.dtype == np.uint8
    assert np.array_equal(got, jvr.decode_frames_py(p, target_fps=5.0, size=28))


@pytest.mark.parametrize("mode", ["default", "start_end", "split", "sample_fps"])
def test_video_extractor_matches_jax(tmp_path, mode):
    p = str(tmp_path / "clip.y4m")
    tvr.write_y4m(p, _frames(t=50, h=32, w=32), fps=10.0)
    data = {"video": p, "id": "v1"}
    kw = {}
    if mode == "start_end":
        kw = {"start_end": (10, 19)}
    elif mode == "split":
        data["split"] = (1.0, 3.0)
    elif mode == "sample_fps":
        kw = {"sample_fps": 2}
    vid, images, idx = tvr.VideoExtractor(N=8).extract(data, **kw)
    wvid, wimages, widx = jvr.VideoExtractor(N=8).extract(data, **kw)
    assert vid == wvid == "v1"
    assert np.array_equal(idx, widx) and np.array_equal(images, wimages)
    assert images.shape[1:] == (3, 32, 32)
    assert images.shape[0] == {"default": 8, "start_end": 8, "split": 8, "sample_fps": 10}[mode]
