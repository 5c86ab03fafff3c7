"""CLIP feature extraction pipelines, in PyTorch.

Counterpart of revisionllm_tpu/data/feature_extraction.py (the reference's
revisionllm/data/feature_extraction/clip_extractor.py:13-176 and the
mad/chapters/msrvtt text extractors): video frames -> ViT-L/14 image features
at a target fps, and query text -> {token_features, cls_features} records,
written to RVFS stores (data/feature_store.py) that training and eval read.

Host side: `.y4m` videos decode through the pure-python reader
(data/video_reader.py, no external binaries); compressed containers
(mp4/mkv) go through ffmpeg when present. Device side: the CLIP encoders
(models/clip.py) in batches on the extractor's device, CUDA unless the
caller asks for the CPU.
"""

from __future__ import annotations

import json
import shutil
import subprocess
from typing import Dict, Tuple

import numpy as np
import torch

from revisionllm_tpu_torch.data.feature_store import RvfsWriter
from revisionllm_tpu_torch.models.weights import params_from_numpy
from revisionllm_tpu_torch.utils.device import resolve_device

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None and shutil.which("ffprobe") is not None


def probe_video(path: str) -> Tuple[float, int, int, int]:
    """(fps, num_frames, width, height) via ffprobe."""
    out = subprocess.run(
        [
            "ffprobe", "-v", "error", "-select_streams", "v:0",
            "-show_entries", "stream=r_frame_rate,nb_frames,width,height",
            "-of", "json", path,
        ],
        capture_output=True, text=True, check=True,
    )
    s = json.loads(out.stdout)["streams"][0]
    num, den = s["r_frame_rate"].split("/")
    fps = float(num) / float(den)
    return fps, int(s.get("nb_frames", 0) or 0), int(s["width"]), int(s["height"])


def decode_frames(path: str, target_fps: float, size: int = 224) -> np.ndarray:
    """Decode at target_fps, scale the shorter side to `size`, center-crop.

    Returns [T, size, size, 3] uint8 (parity: VideoLoader, reference
    clip_extractor.py:100-176: ffmpeg fps filter + center crop). `.y4m`
    inputs always decode through the pure-python reader; other containers
    need ffmpeg."""
    if path.endswith(".y4m"):
        from revisionllm_tpu_torch.data.video_reader import decode_frames_py

        return decode_frames_py(path, target_fps, size)
    if not ffmpeg_available():
        raise RuntimeError(
            "ffmpeg not available and input is not .y4m; transcode to y4m "
            "or install ffmpeg for compressed containers"
        )
    vf = (
        f"fps={target_fps},scale='if(gt(iw,ih),-2,{size})':'if(gt(iw,ih),{size},-2)',"
        f"crop={size}:{size}"
    )
    out = subprocess.run(
        [
            "ffmpeg", "-v", "error", "-i", path, "-vf", vf,
            "-pix_fmt", "rgb24", "-f", "rawvideo", "-",
        ],
        capture_output=True, check=True,
    )
    buf = np.frombuffer(out.stdout, np.uint8)
    T = len(buf) // (size * size * 3)
    return buf[: T * size * size * 3].reshape(T, size, size, 3)


def preprocess_frames(frames: np.ndarray) -> np.ndarray:
    """uint8 [T, H, W, 3] -> normalized f32 [T, 3, H, W] (CLIP transform:
    /255, mean/std; reference clip_extractor.py:30-38)."""
    x = frames.astype(np.float32) / 255.0
    x = (x - CLIP_MEAN) / CLIP_STD
    return np.transpose(x, (0, 3, 1, 2))


def linspace_sample(frames: np.ndarray, n: int) -> np.ndarray:
    idx = np.linspace(0, len(frames) - 1, n, dtype=np.int32)
    return frames[idx]


class ClipFeatureExtractor:
    """Batched image and text feature extraction on `device` (parity:
    ClipFeatureExtractor, reference clip_extractor.py:13-54).
    `clip_params` is convert_hf_clip's tree of numpy arrays, moved to the
    device in f32. A last partial batch runs at its own size: nothing
    is padded to a compiled shape."""

    def __init__(self, clip_params, batch_size: int = 256, device=None):
        from revisionllm_tpu_torch.models import clip as clip_mod

        self.device = resolve_device(device)
        self.params = params_from_numpy(clip_params, self.device, torch.float32)
        self.batch_size = batch_size
        self._clip = clip_mod

    @torch.no_grad()
    def encode_images(self, pixels: np.ndarray) -> np.ndarray:
        """[T, 3, H, W] f32 -> [T, d] f32 features."""
        outs = []
        for start in range(0, len(pixels), self.batch_size):
            chunk = torch.from_numpy(np.ascontiguousarray(pixels[start : start + self.batch_size]))
            out = self._clip.encode_image(self.params, chunk.to(self.device))
            outs.append(out.float().cpu().numpy())
        return np.concatenate(outs, axis=0)

    @torch.no_grad()
    def encode_texts(self, token_ids: np.ndarray) -> Dict[str, np.ndarray]:
        """[B, 77] -> {'cls_features': [B, d], 'token_features': [B, 77, d]},
        the dual return of the reference's modified encode_text."""
        ids = torch.as_tensor(np.asarray(token_ids), device=self.device)
        out = self._clip.encode_text(self.params, ids)
        return {
            "cls_features": out["pooler_output"].float().cpu().numpy(),
            "token_features": out["last_hidden_state"].float().cpu().numpy(),
        }


def extract_video_features(
    extractor: ClipFeatureExtractor,
    video_paths: Dict[str, str],
    out_path: str,
    target_fps: float = 5.0,
    size: int = 224,
) -> int:
    """Videos -> per-video feature tracks in one RVFS store (the per-movie
    frame features of reference chapters_clip_extractor.py:60-121)."""
    n = 0
    with RvfsWriter(out_path) as w:
        for key, path in video_paths.items():
            frames = decode_frames(path, target_fps, size)
            feats = extractor.encode_images(preprocess_frames(frames))
            w.add(key, {"features": feats.astype(np.float32)})
            n += 1
    return n


def extract_text_features(
    extractor: ClipFeatureExtractor,
    queries: Dict[str, str],
    tokenize,
    out_path: str,
    trim_to_eot: bool = True,
    batch_size: int = 256,
) -> int:
    """Query strings -> {token_features, cls_features} records (parity:
    mad_clip_text_extractor.py:57-107: token features trimmed at the EOT
    position). `tokenize(texts) -> [B, 77] int arrays`."""
    keys = list(queries.keys())
    n = 0
    with RvfsWriter(out_path) as w:
        for start in range(0, len(keys), batch_size):
            chunk = keys[start : start + batch_size]
            ids = np.asarray(tokenize([queries[k] for k in chunk]))
            feats = extractor.encode_texts(ids)
            for j, k in enumerate(chunk):
                tok = feats["token_features"][j]
                if trim_to_eot:
                    eot = int(np.argmax(ids[j]))
                    tok = tok[: eot + 1]
                w.add(
                    k,
                    {
                        "token_features": tok.astype(np.float32),
                        "cls_features": feats["cls_features"][j].astype(np.float32),
                    },
                )
                n += 1
    return n
