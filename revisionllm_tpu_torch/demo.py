"""Interactive demo: video chat with the grounding model, in PyTorch.

Counterpart of revisionllm_tpu/demo.py (the reference's demo_gradio.py:
upload a video, 100 frames of CLIP features, a multi-turn chat): a terminal
REPL that streams each answer, the stdlib web UI (webdemo.py) and the same
gradio UI when `gradio` is installed (it is imported only when asked for).

The model comes from a checkpoint directory through eval/loader.load_model
(models/convert.load_pretrained, serving_params_host, params_from_numpy),
so the demo serves the int8 tree stage1.main serves, on CUDA unless
--device says otherwise. Video input is a `.npy` feature file, or a raw
video (`.y4m` through the pure-python reader, other containers through
ffmpeg) encoded by the CLIP of --clip_path on the demo's device
(data/feature_extraction.py).

    python -m revisionllm_tpu_torch.demo --model_base hf/ --stage2 s1/ \\
        --video feats.npy|clip.y4m [--clip_path clip-vit-large-patch14/] \\
        [--web] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import Iterator, List, Tuple

import numpy as np

from revisionllm_tpu_torch.inference import inference, inference_stream


def load_video_features(path: str, clip_extractor=None, num_frames: int = 100) -> np.ndarray:
    """A .npy feature file [T, d], or a raw video decoded at 1 fps,
    linspace-sampled to `num_frames` frames and encoded by `clip_extractor`
    (JAX's demo.py:26-46) -> `num_frames` rows picked by linspace."""
    if path.endswith(".npy"):
        feats = np.load(path)
    else:
        from revisionllm_tpu_torch.data.feature_extraction import (
            decode_frames,
            linspace_sample,
            preprocess_frames,
        )

        if clip_extractor is None:
            raise RuntimeError("raw video input needs a CLIP extractor (--clip_path)")
        frames = linspace_sample(decode_frames(path, target_fps=1.0), num_frames)
        feats = clip_extractor.encode_images(preprocess_frames(frames))
    idx = np.linspace(0, len(feats) - 1, num_frames, dtype=np.int32)
    return feats[idx]


class ChatSession:
    """Multi-turn chat over one video (the reference's gradio_answer loop,
    demo_gradio.py:120-148): the first question carries the <video>
    sentinel, every later one the earlier turns as history."""

    def __init__(self, engine_parts, features: np.ndarray, max_new_tokens: int = 128):
        (self.llama_cfg, self.adapter_cfg, self.params, self.vision,
         self.tokenizer) = engine_parts
        self.features = features
        self.history: List[Tuple[str, str]] = []
        self.max_new_tokens = max_new_tokens

    def _question(self, question: str) -> str:
        return question if self.history else "<video>\n" + question

    def ask(self, question: str) -> str:
        question = self._question(question)
        answer, _ = inference(
            self.llama_cfg, self.adapter_cfg, self.params, self.vision, self.tokenizer,
            self.features[None], question, max_new_tokens=self.max_new_tokens,
            history=self.history,
        )
        self.history.append((question, answer))
        return answer

    def ask_stream(self, question: str) -> Iterator[str]:
        """Yield the growing answer token by token (the reference demo's
        TextStreamer, demo_gradio.py:133-141)."""
        question = self._question(question)
        answer = ""
        for answer in inference_stream(
            self.llama_cfg, self.adapter_cfg, self.params, self.vision, self.tokenizer,
            self.features[None], question, max_new_tokens=self.max_new_tokens,
            history=self.history,
        ):
            yield answer
        self.history.append((question, answer))


def repl(session: ChatSession) -> None:
    """Read questions from stdin until an empty line or EOF; stream each
    answer to stdout."""
    print("video loaded — ask questions (empty line to exit)")
    while True:
        try:
            q = input("user> ").strip()
        except EOFError:
            return
        if not q:
            return
        print("assistant> ", end="", flush=True)
        shown = 0
        for answer in session.ask_stream(q):
            print(answer[shown:], end="", flush=True)
            shown = len(answer)
        print()


def launch_gradio(make_session, host: str = "0.0.0.0", port: int = 7860):
    """The gradio UI; prints a note and returns None without `gradio`."""
    try:
        import gradio as gr
    except ImportError:
        print("gradio is not installed; use the terminal REPL", file=sys.stderr)
        return None

    state = {"session": None}

    def upload(video_file):
        state["session"] = make_session(video_file)
        return "video processed — ask away"

    def answer(question, chat):
        if state["session"] is None:
            return chat + [(question, "upload a video first")]
        return chat + [(question, state["session"].ask(question))]

    with gr.Blocks() as demo:
        video = gr.File(label="video or .npy features")
        status = gr.Textbox()
        chat = gr.Chatbot()
        box = gr.Textbox(label="question")
        video.upload(upload, video, status)
        box.submit(answer, [box, chat], chat)
    demo.launch(server_name=host, server_port=port)
    return demo


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="revisionllm_tpu_torch demo")
    p.add_argument("--model_base", required=True)
    p.add_argument("--pretrain_mm_mlp_adapter", default=None)
    p.add_argument("--pretrain_clip_adapter", default=None)
    p.add_argument("--stage2", default=None)
    p.add_argument("--stage3", default=None)
    p.add_argument("--video", required=True,
                   help=".npy feature file, or a raw video with --clip_path")
    p.add_argument("--clip_path", default=None, help="HF CLIP dir for raw video")
    p.add_argument("--gradio", action="store_true")
    p.add_argument("--web", action="store_true",
                   help="stdlib web UI with token streaming (no gradio needed)")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address for --web (pass 0.0.0.0 to expose; "
                        "the endpoint accepts unauthenticated uploads)")
    p.add_argument("--device", type=str, default=None,
                   help="default cuda (raises without a GPU); cpu for a smoke run")
    return p.parse_args(argv)


def main(argv=None, tokenizer=None):
    args = parse_args(argv)
    from revisionllm_tpu_torch.eval.loader import load_model

    *parts, device = load_model(args, tokenizer)
    clip_extractor = None
    if args.clip_path:
        from revisionllm_tpu_torch.data.feature_extraction import ClipFeatureExtractor
        from revisionllm_tpu_torch.models.clip import convert_hf_clip
        from revisionllm_tpu_torch.models.convert import load_hf_llama_state

        clip_extractor = ClipFeatureExtractor(
            convert_hf_clip(load_hf_llama_state(args.clip_path)), device=device)

    def make_session(video_path):
        return ChatSession(parts, load_video_features(video_path, clip_extractor))

    if args.web:
        from revisionllm_tpu_torch.webdemo import launch_web

        launch_web(make_session, host=args.host, port=args.port)
    elif args.gradio:
        launch_gradio(make_session)
    else:
        repl(make_session(args.video))


if __name__ == "__main__":
    main()
