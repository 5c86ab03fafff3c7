"""Stage-1 dense grounding engine, in PyTorch.

Counterpart of revisionllm_tpu/eval/engine.py::GroundingEngine.ground_windows:
windows are planned once on the host as an integer gather plan; the movie
is shipped to the device once and every chunk's windows are gathered there
from it; each chunk runs adapter -> splice -> prefill -> decode with inline
entropy; every chunk is enqueued before the first is read back, so the
host work of one chunk overlaps the device work of the last. Answers are
parsed and the proposals scored by decode entropy and CLIP cosine.

There is no mesh and no compiled-program cache (PyTorch runs eagerly), so
the movie is not padded to a length bucket. Stage-2 `retrieve` and the
multi-query batch paths wait for a later slice.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from revisionllm_tpu_torch.config import AdapterConfig, EvalConfig, LlamaConfig
from revisionllm_tpu_torch.constants import QUESTIONS
from revisionllm_tpu_torch.conversation import CONV_VICUNA_V1
from revisionllm_tpu_torch.eval import metrics as M
from revisionllm_tpu_torch.eval.similarity import proposal_cosine_scores
from revisionllm_tpu_torch.models import llama, revisionllm
from revisionllm_tpu_torch.models.multimodal import build_splice_plan, stack_plans
from revisionllm_tpu_torch.ops import windows as W
from revisionllm_tpu_torch.tokenization import tokenizer_image_token
from revisionllm_tpu_torch.utils.device import resolve_device


class GroundingEngine:
    """Holds the model parameters (already on `device`) and runs queries."""

    def __init__(
        self,
        llama_cfg: LlamaConfig,
        adapter_cfg: AdapterConfig,
        params: Dict[str, Any],
        vision_params: Dict[str, Any],
        tokenizer,
        eval_cfg: EvalConfig,
        eos_id: int = 2,
        device=None,
    ):
        self.device = resolve_device(device)
        self.llama_cfg = llama_cfg
        self.adapter_cfg = adapter_cfg
        self.params = params
        self.vision_params = vision_params
        self.tokenizer = tokenizer
        self.eval_cfg = eval_cfg
        self.eos_id = eos_id
        self.dtype = llama.torch_dtype(llama_cfg.dtype)
        self._feats_cache: Optional[Tuple[Tuple, torch.Tensor]] = None

    def _features_to_device(self, features: np.ndarray, movie_key=None) -> torch.Tensor:
        """[ctx, d] numpy -> [ctx, d] f32 on the device, cached by movie_key so
        consecutive same-movie queries skip the transfer. Callers make
        movie_key unique per feature content."""
        key = (movie_key,) + tuple(features.shape)
        if movie_key is not None and self._feats_cache is not None \
                and self._feats_cache[0] == key:
            return self._feats_cache[1]
        dev = torch.as_tensor(np.asarray(features, np.float32), device=self.device)
        if movie_key is not None:
            self._feats_cache = (key, dev)
        return dev

    def _prompt_ids(self, sentence: str, question_template: str) -> List[int]:
        """The v1 prompt with the <video> sentinel, tokenized."""
        query = "<video>\n" + question_template.format(sentence)
        prompt = CONV_VICUNA_V1.user_turn_prompt(query)
        return tokenizer_image_token(prompt, self.tokenizer)

    def _decode_answers(self, tokens: np.ndarray, valid: np.ndarray) -> List[str]:
        """Token ids -> stripped answer strings."""
        out = []
        stop = CONV_VICUNA_V1.stop_str
        for row, v in zip(tokens, valid):
            ids = [int(t) for t, ok in zip(row, v) if ok and int(t) != self.eos_id]
            text = self.tokenizer.decode(ids, skip_special_tokens=True).strip()
            if text.endswith(stop):
                text = text[: -len(stop)].strip()
            out.append(text)
        return out

    def _run_chunk(self, plan: Dict[str, torch.Tensor], rows: np.ndarray,
                   feats_dev: torch.Tensor, qf, qv) -> Dict[str, torch.Tensor]:
        """Enqueue one chunk: gather its windows [B, T, d] from the resident
        movie by the int32 index rows, then adapter, splice and decode."""
        images = W.gather_windows(feats_dev, rows).to(self.dtype)
        return revisionllm.generate_grounding(
            self.llama_cfg, self.adapter_cfg, self.params, self.vision_params,
            plan, images, qf, qv, eos_id=self.eos_id,
            max_new_tokens=self.eval_cfg.max_new_tokens,
            temperature=0.0 if self.eval_cfg.greedy else self.eval_cfg.temperature,
        )

    def _read_chunk(self, out) -> Tuple[List[str], np.ndarray]:
        tokens = out["tokens"].cpu().numpy()
        valid = out["valid"].cpu().numpy()
        stats = out["entropy_stats"].cpu().numpy()
        return self._decode_answers(tokens, valid), stats

    def _stage1_plan_idx(self, ctx_len: int) -> np.ndarray:
        """[n, num_frames] global frame indices per dense window (baseline /
        plus_baseline variants included); empty when the movie is shorter
        than one window."""
        ecfg = self.eval_cfg
        clip_length = int(ecfg.debug_window * ecfg.feature_fps)
        if ecfg.baseline:
            global_idx = np.linspace(0, ctx_len - 1, clip_length, dtype=np.int32)
            bounds = W.dense_window_bounds(clip_length, clip_length)
            bounds = bounds[1:2] if len(bounds) > 1 else bounds[:1]
            plan_idx = global_idx[np.asarray(W.window_frame_indices(bounds, ecfg.num_frames))]
        else:
            bounds = W.dense_window_bounds(ctx_len, clip_length)
            if not bounds:
                return np.zeros((0, ecfg.num_frames), np.int32)
            plan_idx = np.asarray(W.window_frame_indices(bounds, ecfg.num_frames), np.int32)
        if len(plan_idx) and ecfg.plus_baseline:
            whole_idx = np.linspace(0, ctx_len - 1, ecfg.num_frames, dtype=np.int32)
            plan_idx = np.concatenate([plan_idx, whole_idx[None]], axis=0)
        return plan_idx

    def ground_windows(
        self,
        features: np.ndarray,
        sentence: str,
        query_feats: Optional[np.ndarray] = None,
        query_cls: Optional[np.ndarray] = None,
        question_key: str = "mad_grounding",
        movie_key=None,
    ) -> Dict[str, Any]:
        """Dense grounding over every window of a feature track.

        features [ctx_l, d] (full movie). Returns answers, per-window entropy
        scores, proposal frames and cosine scores."""
        ecfg = self.eval_cfg
        plan_idx = self._stage1_plan_idx(len(features))
        if not len(plan_idx):
            return {"answers": [], "scores_entropy": [], "score_cos": [], "frames": {}}
        feats_dev = self._features_to_device(features, movie_key)
        ids = self._prompt_ids(sentence, QUESTIONS[question_key])
        chunk = max(ecfg.batch, 1)
        n = len(plan_idx)
        plan = build_splice_plan(
            ids, ecfg.num_frames, len(ids) - 1 + ecfg.num_frames + ecfg.max_new_tokens
        )
        plan_dev = {
            k: torch.as_tensor(v, device=self.device)
            for k, v in stack_plans([plan] * chunk).items()
        }
        qf = qv = None
        if query_feats is not None:
            # ship the [Q, d] query features once, broadcast on the device
            q1 = torch.as_tensor(np.asarray(query_feats), device=self.device).to(self.dtype)
            qf = q1.expand((chunk,) + tuple(q1.shape))
            qv = torch.ones(qf.shape[:2], dtype=torch.bool, device=self.device)

        pending = []
        for start in range(0, n, chunk):
            end = min(start + chunk, n)
            rows = plan_idx[start:end]
            if len(rows) < chunk:  # pad the tail chunk to the chunk size
                rows = np.concatenate([rows, np.repeat(rows[-1:], chunk - len(rows), axis=0)])
            pending.append((end - start, self._run_chunk(plan_dev, rows, feats_dev, qf, qv)))
        answers: List[str] = []
        scores_entropy: List[float] = []
        col = 0 if ecfg.score == "max_entropy" else 2
        for n_valid, out in pending:
            chunk_answers, stats = self._read_chunk(out)
            answers.extend(chunk_answers[:n_valid])
            scores_entropy.extend(stats[:n_valid, col].tolist())
        return self._stage1_finalize(answers, scores_entropy, plan_idx, feats_dev, query_cls)

    def _stage1_finalize(
        self,
        answers: List[str],
        scores_entropy: List[float],
        plan_idx: np.ndarray,
        feats_dev: torch.Tensor,
        query_cls: Optional[np.ndarray],
    ) -> Dict[str, Any]:
        """Proposal parsing, CLIP cosine scoring of every proposal in one
        device call, normalization and merge."""
        ecfg = self.eval_cfg
        frames: Dict[int, Tuple[int, int]] = {}
        for i, a in enumerate(answers):
            span = M.parse_span(a)
            if span is None:
                continue
            f, t = span
            if f == ecfg.num_frames - 1 and t == ecfg.num_frames - 1:
                continue
            frames[i] = (f, t)

        score_cos: List[float] = []
        if query_cls is not None and frames:
            maxlen = ecfg.num_frames
            P = len(frames)
            prop_idx = np.zeros((P, maxlen), np.int64)
            valid = np.zeros((P, maxlen), bool)
            for j, (i, (f, t)) in enumerate(frames.items()):
                row = plan_idx[i][f : t + 1]
                prop_idx[j, : len(row)] = row
                valid[j, : len(row)] = True
            valid_dev = torch.as_tensor(valid, device=self.device)
            props = feats_dev[torch.as_tensor(prop_idx, device=self.device)]
            props = torch.where(valid_dev[..., None], props, torch.zeros_like(props))
            qc = torch.as_tensor(np.asarray(query_cls), dtype=torch.float32, device=self.device)
            score_cos = [float(x) for x in proposal_cosine_scores(qc, props, valid_dev, k=3).cpu()]

        kept_entropy = [scores_entropy[i] for i in frames]
        if ecfg.normalize:
            if score_cos:
                m_s = max(score_cos)
                if m_s != 0:
                    score_cos = [e / m_s for e in score_cos]
            if kept_entropy:
                m_s = max(kept_entropy)
                if m_s != 0:
                    kept_entropy = [e / m_s for e in kept_entropy]

        if "entropy" in ecfg.score:
            if ecfg.score_merge == "add":
                scores = [a - b for a, b in zip(score_cos, kept_entropy)] if score_cos else [-e for e in kept_entropy]
            elif ecfg.score_merge == "multiply" and score_cos:
                scores = [a / b if b else a for a, b in zip(score_cos, kept_entropy)]
            else:
                scores = [-e for e in kept_entropy]
        else:
            scores = score_cos

        return {
            "answers": answers,
            "frames": frames,
            "scores": scores,
            "scores_entropy": scores_entropy,
            "score_cos": score_cos,
            "num_windows": len(plan_idx),
        }
