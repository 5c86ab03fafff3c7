"""Pure-python video decode: Y4M reader/writer + frame sampling. A host
copy of revisionllm_tpu/data/video_reader.py (NumPy only).

The reference decodes raw video through decord
(revisionllm/mm_utils.py:126-174 VideoExtractor) or ffmpeg
(data/feature_extraction/clip_extractor.py:100-176, demo_gradio.py:80-104).
YUV4MPEG2 (.y4m) is a ~50-line wire format
(plain-text header + FRAME-delimited planar YUV), decodable in numpy at full
fidelity — enough to exercise the whole decode -> sample -> scale/crop ->
CLIP-encode chain end-to-end without external binaries. ffmpeg, when present,
still handles compressed containers (mp4/mkv); `.y4m` always takes this path
so tests and demos are deterministic across environments.

Colorspace: BT.601 limited-range YCbCr (the y4m convention). Scaling is
bilinear (ffmpeg defaults to bicubic — a documented divergence of a few
intensity levels; irrelevant downstream of CLIP normalization).
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "read_y4m",
    "write_y4m",
    "resample_fps",
    "scale_shorter_center_crop",
    "decode_frames_py",
    "VideoExtractor",
]


# ------------------------------------------------------------------ y4m wire


def _yuv_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """BT.601 limited-range YCbCr planes [H, W] -> uint8 RGB [H, W, 3]."""
    yf = y.astype(np.float32) - 16.0
    cbf = cb.astype(np.float32) - 128.0
    crf = cr.astype(np.float32) - 128.0
    r = 1.164 * yf + 1.596 * crf
    g = 1.164 * yf - 0.392 * cbf - 0.813 * crf
    b = 1.164 * yf + 2.017 * cbf
    return np.clip(np.stack([r, g, b], axis=-1) + 0.5, 0, 255).astype(np.uint8)


def _rgb_to_yuv(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """uint8 RGB [H, W, 3] -> BT.601 limited-range (y, cb, cr) uint8 planes."""
    x = rgb.astype(np.float32) / 255.0
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 16.0 + 65.481 * r + 128.553 * g + 24.966 * b
    cb = 128.0 - 37.797 * r - 74.203 * g + 112.0 * b
    cr = 128.0 + 112.0 * r - 93.786 * g - 18.214 * b
    to8 = lambda p: np.clip(p + 0.5, 0, 255).astype(np.uint8)
    return to8(y), to8(cb), to8(cr)


def _upsample2(plane: np.ndarray) -> np.ndarray:
    """Nearest 2x2 chroma upsample ([H/2, W/2] -> [H, W])."""
    return np.repeat(np.repeat(plane, 2, axis=0), 2, axis=1)


def _open_y4m(path: str) -> Tuple[List[Callable[[], np.ndarray]], float]:
    """Parse a YUV4MPEG2 file -> (one thunk a frame, decoding it to uint8
    RGB [H, W, 3], fps), so that a reader converts only the frames it
    keeps.

    Supports C420* (all 4:2:0 siting variants decode alike with nearest
    upsampling), C422, C444 and Cmono. Raises on anything else.
    """
    with open(path, "rb") as f:
        data = f.read()
    nl = data.index(b"\n")
    header = data[:nl].decode("ascii")
    if not header.startswith("YUV4MPEG2"):
        raise ValueError(f"{path}: not a YUV4MPEG2 stream")
    w = h = 0
    fps = 30.0
    cs = "420"
    for tok in header.split()[1:]:
        tag, val = tok[0], tok[1:]
        if tag == "W":
            w = int(val)
        elif tag == "H":
            h = int(val)
        elif tag == "F":
            num, den = val.split(":")
            fps = float(num) / float(den)
        elif tag == "C":
            cs = val
    if not (w and h):
        raise ValueError(f"{path}: missing W/H in y4m header: {header!r}")
    if cs.startswith("420"):
        cw, ch = w // 2, h // 2
    elif cs.startswith("422"):
        cw, ch = w // 2, h
    elif cs.startswith("444"):
        cw, ch = w, h
    elif cs.startswith("mono"):
        cw = ch = 0
    else:
        raise ValueError(f"{path}: unsupported y4m colorspace C{cs}")
    ysz, csz = w * h, cw * ch

    def frame(pos: int) -> np.ndarray:
        y = np.frombuffer(data, np.uint8, ysz, pos).reshape(h, w)
        pos += ysz
        if csz:
            cb = np.frombuffer(data, np.uint8, csz, pos).reshape(ch, cw)
            pos += csz
            cr = np.frombuffer(data, np.uint8, csz, pos).reshape(ch, cw)
            if cs.startswith("420"):
                cb, cr = _upsample2(cb), _upsample2(cr)
            elif cs.startswith("422"):
                cb = np.repeat(cb, 2, axis=1)
                cr = np.repeat(cr, 2, axis=1)
        else:
            cb = cr = np.full((h, w), 128, np.uint8)
        return _yuv_to_rgb(y, cb, cr)

    frames = []
    pos = nl + 1
    while pos < len(data):
        fnl = data.index(b"\n", pos)
        if not data[pos:fnl].startswith(b"FRAME"):
            raise ValueError(f"{path}: bad FRAME marker at byte {pos}")
        pos = fnl + 1
        frames.append(functools.partial(frame, pos))
        pos += ysz + 2 * csz
    return frames, fps


def read_y4m(path: str) -> Tuple[np.ndarray, float]:
    """Decode a YUV4MPEG2 file -> (uint8 RGB frames [T, H, W, 3], fps)."""
    frames, fps = _open_y4m(path)
    return np.stack([f() for f in frames], axis=0), fps


def write_y4m(path: str, frames: np.ndarray, fps: float = 25.0) -> None:
    """uint8 RGB [T, H, W, 3] -> C444 y4m file (lossless chroma — the
    round-trip error is the +-1-level BT.601 matrix quantization only)."""
    frames = np.asarray(frames, np.uint8)
    T, h, w, _ = frames.shape
    num, den = (int(round(fps * 1000)), 1000) if fps != int(fps) else (int(fps), 1)
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{num}:{den} Ip A1:1 C444\n".encode())
        for t in range(T):
            y, cb, cr = _rgb_to_yuv(frames[t])
            f.write(b"FRAME\n")
            f.write(y.tobytes())
            f.write(cb.tobytes())
            f.write(cr.tobytes())


# ------------------------------------------------------------- frame sampling


def resample_fps(num_frames: int, src_fps: float, target_fps: float) -> np.ndarray:
    """Source-frame indices approximating ffmpeg's `fps=target` filter:
    one output frame per 1/target_fps of source time, each taking the
    nearest source frame."""
    duration = num_frames / src_fps
    n_out = max(int(round(duration * target_fps)), 1)
    t = (np.arange(n_out) + 0.5) / target_fps
    return np.minimum((t * src_fps).astype(np.int32), num_frames - 1)


def _bilinear_resize(frames: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """uint8 [T, H, W, 3] -> [T, out_h, out_w, 3] (align-corners=False), 8
    frames at a time, so that the f32 temporaries stay in cache."""
    if len(frames) > 8:
        return np.concatenate([_bilinear_resize(frames[i : i + 8], out_h, out_w)
                               for i in range(0, len(frames), 8)], axis=0)
    T, H, W, C = frames.shape
    ys = (np.arange(out_h) + 0.5) * H / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * W / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int32), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(np.int32), 0, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    wy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)[None, :, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)[None, None, :, None]
    f = frames.astype(np.float32)
    top = f[:, y0][:, :, x0] * (1 - wx) + f[:, y0][:, :, x1] * wx
    bot = f[:, y1][:, :, x0] * (1 - wx) + f[:, y1][:, :, x1] * wx
    out = top * (1 - wy) + bot * wy
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


def scale_shorter_center_crop(frames: np.ndarray, size: int) -> np.ndarray:
    """Scale the shorter side to `size` (bilinear), center-crop to
    [size, size] — the ffmpeg vf chain of feature_extraction.decode_frames."""
    T, H, W, _ = frames.shape
    if H <= W:
        nh, nw = size, max(int(round(W * size / H)), size)
    else:
        nh, nw = max(int(round(H * size / W)), size), size
    scaled = _bilinear_resize(frames, nh, nw)
    y0 = (nh - size) // 2
    x0 = (nw - size) // 2
    return scaled[:, y0 : y0 + size, x0 : x0 + size]


def decode_frames_py(path: str, target_fps: float, size: int = 224) -> np.ndarray:
    """Pure-python counterpart of feature_extraction.decode_frames for .y4m
    inputs: decode, fps-resample, scale shorter side, center crop.
    Returns [T, size, size, 3] uint8."""
    frames, src_fps = _open_y4m(path)
    idx = resample_fps(len(frames), src_fps, target_fps)
    return scale_shorter_center_crop(np.stack([frames[i]() for i in idx], axis=0), size)


# ---------------------------------------------------- VideoExtractor parity


class VideoExtractor:
    """Linspace frame sampler over a decoded video (parity: reference
    mm_utils.py:126-174 VideoExtractor over decord).

    extract(data, start_end=None, sample_fps=0) -> (id, images, indices):
    - default: N frames linspace-sampled over [0, total)
    - start_end=(s, e): linspace over the frame range [s, e]
    - data['split']=(t0, t1): seconds -> frame range via the stream fps
    - sample_fps > 0: total*sample_fps/fps frames instead of N
    images are uint8 [T, 3, H, W] (the reference returns the same layout as
    a torch tensor)."""

    def __init__(self, N: int = 100):
        self.N = N

    def extract(
        self,
        data: dict,
        start_end: Optional[Sequence[float]] = None,
        sample_fps: float = 0,
    ):
        vid = data["id"]
        frames, fps = read_y4m(data["video"])
        total = len(frames)
        if start_end is None:
            start, end = 0, total - 1
        else:
            start, end = int(start_end[0]), int(start_end[1])
            total = end - start + 1
        split = data.get("split")
        if split is not None:
            start = max(int(fps * split[0]), 0)
            end = min(int(fps * split[1]), total - 1)
        if sample_fps > 0:
            n = int((total * sample_fps) // fps)
            idx = np.linspace(start, end, n, dtype=np.int32)
        else:
            idx = np.linspace(start, end, self.N, dtype=np.int32)
        images = frames[idx].transpose(0, 3, 1, 2)
        return vid, images, idx
