"""Batched hierarchical grounding engine, in PyTorch.

Counterpart of revisionllm_tpu/eval/engine.py::GroundingEngine: windows are
planned once on the host as an integer gather plan; the movie is shipped to
the device once and every chunk's windows are gathered there from it; each
chunk runs adapter -> splice -> prefill -> decode with inline entropy; every
chunk is enqueued before the first is read back.

Stage 1 (`ground_windows`, and `ground_windows_batch` for several queries
over one movie): every dense window answers "From X to Y" / "Not Present";
proposals are scored by decode entropy and CLIP cosine. Stage 2 (`retrieve`,
`retrieve_batch`): strided windows are compressed to one CLS token each by
the hierarchy adapter, shuffled, zoom-repeated, and the LLM answers
"In video N" per multi-scale pass; all passes are rows of one call, padded
to a row bucket (REVISIONLLM_S2_ROW_BUCKETS). Under
REVISIONLLM_SHARED_PREFIX=1 a chunk whose rows share their prompt up to the
video block prefills that prefix once (llama.prefill_shared_prefix).

Dense captioning (`caption_windows`) answers the JSON-event prompt for every
dense window; MSR-VTT-style text-to-video retrieval (`retrieve_videos`)
ranks a candidate corpus by passes of eval_cfg.batch video-CLS tokens.

`mesh=` (parallel/mesh.py) serves one engine across ranks, as JAX's does:
the weights are this rank's shards (parallel/serve.py), the adapter is
replicated, and every chunk's rows split over the (data, fsdp) axes when
they divide (stage 1's chunk of 64 does; a stage-2 row bucket may not, and
then every rank runs every row), with the outputs gathered so that every
rank reads the whole chunk. There is no compiled-program cache (PyTorch
runs eagerly), so the movie is not padded to a length bucket.

Every entry point is the root span of a request (utils/spans.py), with
`engine.plan` (the host's planning and what it ships), one `engine.chunk`
a call enqueued (its rows and positions, live and padded), one
`engine.read` a chunk read back, and `engine.finalize` (the scoring tail)
beneath it.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from revisionllm_tpu_torch.config import AdapterConfig, EvalConfig, LlamaConfig
from revisionllm_tpu_torch.constants import QUESTIONS
from revisionllm_tpu_torch.conversation import CONV_VICUNA_V1
from revisionllm_tpu_torch.eval import metrics as M
from revisionllm_tpu_torch.eval.similarity import proposal_cosine_scores
from revisionllm_tpu_torch.models import llama, revisionllm
from revisionllm_tpu_torch.models.multimodal import KIND_VIDEO, build_splice_plan, stack_plans
from revisionllm_tpu_torch.ops import windows as W
from revisionllm_tpu_torch.parallel.mesh import batch_sharding
from revisionllm_tpu_torch.parallel.serve import gather_outputs, shard_params_for_inference
from revisionllm_tpu_torch.tokenization import tokenizer_image_token
from revisionllm_tpu_torch.utils import spans
from revisionllm_tpu_torch.utils.device import resolve_device


CAPTION_PROMPT = (
    "Could you please describe the events in the video in detail? "
    "Be specific about the activities of individuals, their "
    "surroundings, and interactions with others. The output should "
    'be in JSON format, structured as follows: {"event": "xx", '
    '"timestamps": "from xx to xx"}.'
)


def _map_retrieval_answers(
    answers: Sequence[str],
    inv_entropy: Sequence[float],
    starts: Sequence[int],
    batch: int,
    num_candidates: int,
) -> Tuple[List[int], List[float]]:
    """Map per-pass 'In video N' answers to corpus candidate ids and scores.

    The tail pass overlaps earlier passes (start = V - batch) and pads rows
    by repeating the last candidate when V < batch, so an answer pointing at
    a padded slot maps to the candidate it duplicates, and a candidate
    chosen by several passes keeps only its best score (repeats would push
    the ground truth's rank later and distort R@K and MedR)."""
    best: Dict[int, float] = {}
    for p, a in enumerate(answers):
        n = M.parse_single(a)
        if n is None:
            continue
        n_rows = min(batch, num_candidates - starts[p])  # real rows this pass
        cand = starts[p] + min(max(n, 0), n_rows - 1)
        s = inv_entropy[p]
        if s > best.get(cand, float("-inf")):
            best[cand] = s
    chosen = list(best.keys())
    return chosen, [best[c] for c in chosen]


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
        mesh=None,
    ):
        """`params` are the whole tree; with `mesh` the engine keeps this
        rank's shards of it (serve.shard_params_for_inference)."""
        self.device = resolve_device(device)
        self.llama_cfg = llama_cfg
        self.adapter_cfg = adapter_cfg
        self.mesh = mesh
        self.params = shard_params_for_inference(mesh, params)
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
            spans.note(shipped_bytes=0)
            return self._feats_cache[1]
        dev = torch.as_tensor(np.asarray(features, np.float32), device=self.device)
        spans.note(shipped_bytes=dev.numel() * dev.element_size())
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

    @staticmethod
    def _shared_prefix_len(plan_np: Dict[str, np.ndarray]) -> int:
        """Rows with identical plans share every token before the first video
        slot (the text is the same, the video differs): that many, when
        REVISIONLLM_SHARED_PREFIX=1 (default off, as in the JAX package) and
        the chunk has two rows or more; else 0."""
        if os.environ.get("REVISIONLLM_SHARED_PREFIX", "0") != "1":
            return 0
        kind = plan_np["kind"]
        if kind.shape[0] < 2 or not (kind == kind[0]).all() or not (
            plan_np["text_ids"] == plan_np["text_ids"][0]
        ).all():
            return 0
        vid_pos = np.where(kind[0] == KIND_VIDEO)[0]
        return int(vid_pos[0]) if len(vid_pos) else 0

    def _run_chunk(self, plan_np: Dict[str, np.ndarray], rows: np.ndarray,
                   feats_dev: torch.Tensor, qf, qv, n_live: int) -> Dict[str, torch.Tensor]:
        """Enqueue one chunk: ship its splice plan, gather its windows from
        the resident movie by the int32 index rows ([B, T] for stage 1,
        [R, V, T] for stage 2), then adapter, splice and decode. A plan with
        "qsel" (a multi-query chunk) picks each row's query features from
        the [Q, Qt, d] stack qf. Under a mesh this rank runs its rows of the
        chunk and the outputs are gathered (module docstring). The first
        `n_live` rows are wanted, the rest pad the chunk: the `engine.chunk`
        span counts the chunk's rows and positions, and the live ones'."""
        lengths = plan_np["lengths"]
        with spans.span("engine.chunk", device=self.device, rows=len(lengths),
                        live_rows=n_live, positions=int(plan_np["kind"].size),
                        live_positions=int(lengths[:n_live].sum())):
            spl = self._shared_prefix_len(plan_np)
            shard, B = batch_sharding(self.mesh), len(rows)
            if shard.splits(B):
                if qf is not None and "qsel" not in plan_np:
                    qf, qv = shard.local(qf, B), shard.local(qv, B)
                plan_np = {k: shard.local(v, B) for k, v in plan_np.items()}
                rows = shard.local(rows, B)
            plan = {k: torch.as_tensor(v, device=self.device) for k, v in plan_np.items()}
            qsel = plan.pop("qsel", None)
            if qsel is not None:
                qf, qv = qf[qsel.long()], qv[qsel.long()]
            images = W.gather_windows(feats_dev, rows).to(self.dtype)
            out = revisionllm.generate_grounding(
                self.llama_cfg, self.adapter_cfg, self.params, self.vision_params,
                plan, images, qf, qv, eos_id=self.eos_id,
                max_new_tokens=self.eval_cfg.max_new_tokens,
                temperature=0.0 if self.eval_cfg.greedy else self.eval_cfg.temperature,
                shared_prefix_len=spl, mesh=self.mesh,
            )
            return gather_outputs(out, shard, B)

    def _read_chunk(self, out) -> Tuple[List[str], np.ndarray]:
        with spans.span("engine.read"):
            tokens = out["tokens"].cpu().numpy()
            valid = out["valid"].cpu().numpy()
            stats = out["entropy_stats"].cpu().numpy()
            return self._decode_answers(tokens, valid), stats

    def _broadcast_query_feats(self, query_feats: np.ndarray, n: int):
        """Ship the [Q, d] query features once and broadcast them to
        [n, Q, d] on the device, with an all-true mask."""
        q1 = torch.as_tensor(np.asarray(query_feats), device=self.device).to(self.dtype)
        qf = q1.expand((n,) + tuple(q1.shape))
        return qf, torch.ones(qf.shape[:2], dtype=torch.bool, device=self.device)

    def _query_feats_stack(self, queries: Sequence[Dict[str, Any]], d: int, what: str):
        """The queries' features as one [Q, Qt, d] device stack, padded to
        the longest, with its mask; (None, None) when no query has any. A
        batch must be uniform: an all-false mask is not the no-feature
        program (T2V cross-attention over an empty set)."""
        have = [q.get("query_feats") is not None for q in queries]
        if not any(have):
            return None, None
        if not all(have):
            raise ValueError(f"{what}: queries must uniformly have or lack query_feats")
        qts = [len(q["query_feats"]) for q in queries]
        qf = np.zeros((len(queries), max(qts), d), np.float32)
        qv = np.zeros((len(queries), max(qts)), bool)
        for i, q in enumerate(queries):
            qf[i, : qts[i]] = q["query_feats"]
            qv[i, : qts[i]] = True
        return (torch.as_tensor(qf, device=self.device).to(self.dtype),
                torch.as_tensor(qv, device=self.device))

    def _cosine_scores(self, feats_dev: torch.Tensor, prop_idx: np.ndarray,
                       valid: np.ndarray, query_cls: np.ndarray) -> List[float]:
        """CLIP cosine of each proposal [P, T] of frame indices (valid [P, T])
        against the query CLS, in one device call."""
        valid_dev = torch.as_tensor(valid, device=self.device)
        props = feats_dev[torch.as_tensor(prop_idx, dtype=torch.long, device=self.device)]
        props = torch.where(valid_dev[..., None], props, torch.zeros_like(props))
        qc = torch.as_tensor(np.asarray(query_cls), dtype=torch.float32, device=self.device)
        return [float(x) for x in proposal_cosine_scores(qc, props, valid_dev, k=3).cpu()]

    # ---------------------------------------------------------------- stage 1

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
        with spans.span("engine.ground_windows"):
            with spans.span("engine.plan"):
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
                plan_np = stack_plans([plan] * chunk)
                qf = qv = None
                if query_feats is not None:
                    qf, qv = self._broadcast_query_feats(query_feats, chunk)
            spans.note(windows=n)

            pending = []
            for start in range(0, n, chunk):
                end = min(start + chunk, n)
                rows = plan_idx[start:end]
                if len(rows) < chunk:  # pad the tail chunk to the chunk size
                    rows = np.concatenate([rows, np.repeat(rows[-1:], chunk - len(rows), axis=0)])
                pending.append((end - start,
                                self._run_chunk(plan_np, rows, feats_dev, qf, qv, end - start)))
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
        with spans.span("engine.finalize"):
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
            spans.note(proposals=len(frames))

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
                score_cos = self._cosine_scores(feats_dev, prop_idx, valid, query_cls)

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
                    scores = ([a - b for a, b in zip(score_cos, kept_entropy)] if score_cos
                              else [-e for e in kept_entropy])
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

    def ground_windows_batch(
        self,
        features: np.ndarray,
        queries: Sequence[Dict[str, Any]],
        question_key: str = "mad_grounding",
        movie_key=None,
    ) -> List[Dict[str, Any]]:
        """Dense grounding for several queries over one movie in shared
        chunks (the throughput mode).

        queries: each {"sentence": str, "query_feats": [Qt, d] | None,
        "query_cls": [d] | None}. Rows of all queries pack densely into
        chunks of eval_cfg.batch, query-major; per-row splice plans carry
        each query's prompt (one length for all: the longest), and the query
        features ride as one [Q, Qt, d] device stack picked per row by the
        plan's qsel index. Results equal per-query ground_windows calls."""
        ecfg = self.eval_cfg
        Q = len(queries)
        if Q == 0:
            return []
        with spans.span("engine.ground_windows_batch"):
            with spans.span("engine.plan"):
                plan_idx = self._stage1_plan_idx(len(features))
                if not len(plan_idx):
                    return [{"answers": [], "scores_entropy": [], "score_cos": [], "frames": {}}
                            for _ in range(Q)]
                feats_dev = self._features_to_device(features, movie_key)
                chunk = max(ecfg.batch, 1)
                n = len(plan_idx)
                ids_list = [self._prompt_ids(q["sentence"], QUESTIONS[question_key])
                            for q in queries]
                max_len = (max(len(i) for i in ids_list) - 1 + ecfg.num_frames
                           + ecfg.max_new_tokens)
                plans = [build_splice_plan(ids, ecfg.num_frames, max_len) for ids in ids_list]
                qf_all, qv_all = self._query_feats_stack(queries, features.shape[-1],
                                                         "ground_windows_batch")
            spans.note(windows=Q * n)

            row_q = np.repeat(np.arange(Q, dtype=np.int32), n)
            row_w = np.tile(np.arange(n, dtype=np.int32), Q)
            total = Q * n
            pending = []
            for start in range(0, total, chunk):
                end = min(start + chunk, total)
                sel_q, sel_w = row_q[start:end], row_w[start:end]
                if end - start < chunk:  # pad the tail chunk to the chunk size
                    pad = chunk - (end - start)
                    sel_q = np.concatenate([sel_q, np.repeat(sel_q[-1:], pad)])
                    sel_w = np.concatenate([sel_w, np.repeat(sel_w[-1:], pad)])
                plan_np = stack_plans([plans[qi] for qi in sel_q])
                if qf_all is not None:
                    plan_np["qsel"] = sel_q
                pending.append((end - start, self._run_chunk(plan_np, plan_idx[sel_w], feats_dev,
                                                             qf_all, qv_all, end - start)))

            col = 0 if ecfg.score == "max_entropy" else 2
            answers_all: List[str] = []
            entropy_all: List[float] = []
            for n_valid, out in pending:
                chunk_answers, stats = self._read_chunk(out)
                answers_all.extend(chunk_answers[:n_valid])
                entropy_all.extend(stats[:n_valid, col].tolist())
            return [
                self._stage1_finalize(answers_all[qi * n : (qi + 1) * n],
                                      entropy_all[qi * n : (qi + 1) * n], plan_idx, feats_dev,
                                      q.get("query_cls"))
                for qi, q in enumerate(queries)
            ]

    def caption_windows(self, features: np.ndarray, prompt: Optional[str] = None,
                        movie_key=None) -> Dict[str, Any]:
        """Dense captioning: every dense window of the movie answers
        `prompt` (default the JSON-event prompt of the reference's
        'captioning' task, eval_nlq_negative.py:265-268) in chunks of
        eval_cfg.batch windows gathered from the resident movie, the last
        padded by repeating its last row. A caption is at most
        eval_cfg.max_new_tokens long."""
        ecfg = self.eval_cfg
        with spans.span("engine.caption_windows"):
            with spans.span("engine.plan"):
                clip_length = int(ecfg.debug_window * ecfg.feature_fps)
                bounds = W.dense_window_bounds(len(features), clip_length)
                if not bounds:
                    return {"answers": []}
                plan_idx = np.asarray(W.window_frame_indices(bounds, ecfg.num_frames), np.int32)
                feats_dev = self._features_to_device(features, movie_key)
                full = CONV_VICUNA_V1.user_turn_prompt(
                    "<video>\n " + (CAPTION_PROMPT if prompt is None else prompt))
                ids = tokenizer_image_token(full, self.tokenizer)
                chunk = max(ecfg.batch, 1)
                plan = build_splice_plan(
                    ids, ecfg.num_frames, len(ids) - 1 + ecfg.num_frames + ecfg.max_new_tokens
                )
                plan_np = stack_plans([plan] * chunk)
            spans.note(windows=len(bounds))
            pending = []
            for start in range(0, len(bounds), chunk):
                end = min(start + chunk, len(bounds))
                rows = plan_idx[start:end]
                if len(rows) < chunk:
                    rows = np.concatenate([rows, np.repeat(rows[-1:], chunk - len(rows), axis=0)])
                pending.append((end - start, self._run_chunk(plan_np, rows, feats_dev, None, None,
                                                             end - start)))
            answers: List[str] = []
            for n_valid, out in pending:
                answers.extend(self._read_chunk(out)[0][:n_valid])
            return {"answers": answers}

    # ---------------------------------------------------------------- stage 2

    @staticmethod
    def _stage2_row_bucket(n_pass: int) -> int:
        """The smallest row bucket (REVISIONLLM_S2_ROW_BUCKETS, default
        "7,10,14") that fits `n_pass` stage-2 passes; the largest when none
        does, and the passes then run as several calls of that size. Padding
        to a few fixed shapes keeps the shapes a later CUDA-graph capture
        needs."""
        buckets = sorted(
            int(b) for b in os.environ.get("REVISIONLLM_S2_ROW_BUCKETS", "7,10,14").split(",")
        )
        fit = [b for b in buckets if b >= max(n_pass, 1)]
        return min(fit) if fit else max(buckets)

    def _stage2_passes(self, win_idx: np.ndarray, rng: np.random.Generator):
        """Every (zoom, call) pass: each sees exactly eval_cfg.batch window
        tokens (windows repeated `zoom` times), shuffled by `rng`, so all
        passes share one shape and run as rows of one call. Returns (starts,
        permutations, zooms, the call counter within each zoom, [batch, T]
        frame indices per pass)."""
        ecfg = self.eval_cfg
        starts: List[int] = []
        indexes: List[np.ndarray] = []
        hierarchy_zooms: List[int] = []
        call_in_zoom: List[int] = []
        row_idx: List[np.ndarray] = []
        V = len(win_idx)
        for zoom in ecfg.hierarchy_zooms:
            batch = max(ecfg.batch // zoom, 1)
            for i in range(int(np.ceil(V / batch))):
                call_in_zoom.append(i)
                start = i * batch
                end = min(start + batch, V)
                if end - start < batch:
                    start = max(end - batch, 0)
                starts.append(start)
                row = win_idx[start : start + batch]
                if len(row) < batch:
                    row = np.concatenate([row, np.repeat(row[-1:], batch - len(row), axis=0)], 0)
                perm = rng.permutation(row.shape[0])
                indexes.append(perm)
                row = row[perm]
                if zoom > 1:
                    row = np.repeat(row, zoom, axis=0)
                hierarchy_zooms.append(zoom)
                row_idx.append(row)
        return starts, indexes, hierarchy_zooms, call_in_zoom, row_idx

    def _stage2_win_idx(self, ctx_len: int) -> np.ndarray:
        """[V, num_frames] frame indices of every strided window."""
        ecfg = self.eval_cfg
        clip_length = int(ecfg.debug_window * ecfg.feature_fps)
        bounds = W.strided_window_bounds(ctx_len, clip_length, ecfg.stride)
        return np.asarray(W.window_frame_indices(bounds, ecfg.num_frames), np.int32)

    def _run_stage2_rows(self, flat_rows: List[np.ndarray], plans: List,
                         flat_q: List[int], feats_dev, qf, qv, qsel: bool):
        """Run the passes as rows of calls of one row bucket (the last
        padded by repeating its last row); returns (answers, 1 / mean
        entropy, 1 / max entropy) per pass."""
        row_batch = self._stage2_row_bucket(len(flat_rows))
        pending = []
        for rstart in range(0, len(flat_rows), row_batch):
            rows = flat_rows[rstart : rstart + row_batch]
            sel_q = flat_q[rstart : rstart + row_batch]
            n_rows = len(rows)
            if n_rows < row_batch:
                rows = rows + [rows[-1]] * (row_batch - n_rows)
                sel_q = sel_q + [sel_q[-1]] * (row_batch - n_rows)
            plan_np = stack_plans([plans[qi] for qi in sel_q])
            if qsel:
                plan_np["qsel"] = np.asarray(sel_q, np.int32)
            pending.append((n_rows, self._run_chunk(plan_np, np.stack(rows, axis=0), feats_dev,
                                                    qf, qv, n_rows)))
        answers: List[str] = []
        mean_entropy: List[float] = []
        max_entropy: List[float] = []
        for n_rows, out in pending:
            chunk_answers, stats = self._read_chunk(out)
            answers.extend(chunk_answers[:n_rows])
            for r in range(n_rows):
                max_entropy.append(1.0 / max(stats[r, 0], 1e-9))
                mean_entropy.append(1.0 / max(stats[r, 2], 1e-9))
        return answers, mean_entropy, max_entropy

    def retrieve(
        self,
        features: np.ndarray,
        sentence: str,
        query_feats: Optional[np.ndarray] = None,
        query_cls: Optional[np.ndarray] = None,
        grounding_windows: Optional[List[int]] = None,
        rng: Optional[np.random.Generator] = None,
        question_key: str = "retrieval",
        movie_key=None,
    ) -> Dict[str, Any]:
        """Hierarchical coarse retrieval with multi-scale zoom passes.

        features [ctx_l, d]. Every pass sees eval_cfg.batch window-CLS
        tokens; all passes of all zooms are rows of one call (or of a few
        calls of the largest row bucket). Window slicing, shuffling and zoom
        repetition happen in index space; frames are gathered on the device
        from the resident movie. grounding_windows restricts the windows (a
        stage-1 prefilter)."""
        rng = rng or np.random.default_rng(42)
        with spans.span("engine.retrieve"):
            with spans.span("engine.plan"):
                win_idx = self._stage2_win_idx(len(features))
                if grounding_windows is None:
                    grounding_windows = list(range(len(win_idx)))
                else:
                    win_idx = win_idx[np.asarray(grounding_windows, np.int32)]
                feats_dev = self._features_to_device(features, movie_key)
                ids = self._prompt_ids(sentence, QUESTIONS[question_key])
                starts, indexes, zooms, calls, row_idx = self._stage2_passes(win_idx, rng)
                num_videos = row_idx[0].shape[0] if row_idx else self.eval_cfg.batch
                plan = build_splice_plan(
                    ids, num_videos, len(ids) - 1 + num_videos + self.eval_cfg.max_new_tokens
                )
                qf = qv = None
                if query_feats is not None:
                    qf, qv = self._broadcast_query_feats(
                        query_feats, self._stage2_row_bucket(len(row_idx)))
            spans.note(windows=len(win_idx))
            answers, mean_entropy, max_entropy = self._run_stage2_rows(
                row_idx, [plan], [0] * len(row_idx), feats_dev, qf, qv, qsel=False)
            return self._stage2_finalize(
                answers, mean_entropy, max_entropy, starts, indexes, zooms, calls, row_idx,
                grounding_windows, len(win_idx), feats_dev, query_cls,
            )

    def _stage2_finalize(
        self,
        answers: List[str],
        mean_entropy: List[float],
        max_entropy: List[float],
        starts: List[int],
        indexes: List[np.ndarray],
        hierarchy_zooms: List[int],
        call_in_zoom: List[int],
        row_idx: List[np.ndarray],
        grounding_windows: List[int],
        V: int,
        feats_dev: torch.Tensor,
        query_cls: Optional[np.ndarray],
    ) -> Dict[str, Any]:
        """The scoring tail of retrieve: each parsed answer is mapped back
        through zoom, permutation and prefilter (with the within-zoom index
        quirk of metrics.stage2_chosen_windows), and the +-1 window
        neighbourhood of the pass's rows is scored by CLIP cosine against
        the query CLS, in one device call; 0.0 for a pass whose answer holds
        no integer."""
        with spans.span("engine.finalize"):
            score_cos: List[float] = []
            if query_cls is not None and answers:
                chosen = M.stage2_chosen_windows(
                    answers, starts, indexes, hierarchy_zooms, call_in_zoom, grounding_windows,
                    [ri.shape[0] for ri in row_idx],
                )
                to_score = [row_idx[p][n2] for p, ns in enumerate(chosen) if ns for n2 in ns]
                spans.note(proposals=len(to_score))
                scores_flat: List[float] = []
                if to_score:
                    prop_idx = np.stack(to_score, axis=0)
                    scores_flat = self._cosine_scores(
                        feats_dev, prop_idx, np.ones(prop_idx.shape, bool), query_cls)
                it = iter(scores_flat)
                for ns in chosen:
                    if ns is None:
                        score_cos.append(0.0)
                    else:
                        score_cos.extend(next(it) for _ in ns)
            return {
                "answers": answers,
                "starts": starts,
                "indexes": [idx.tolist() for idx in indexes],
                "hierarchy_zooms": hierarchy_zooms,
                "mean_entropy": mean_entropy,
                "max_entropy": max_entropy,
                "score_cos": score_cos,
                "grounding_windows": grounding_windows,
                "num_windows": V,
            }

    def retrieve_batch(
        self,
        features: np.ndarray,
        queries: Sequence[Dict[str, Any]],
        question_key: str = "retrieval",
        movie_key=None,
    ) -> List[Dict[str, Any]]:
        """Hierarchical retrieval for several queries over one movie, all
        their passes as rows of as few row-bucket calls as fit (the
        throughput mode).

        queries: each {"sentence", "query_feats", "query_cls",
        "grounding_windows": list | None, "rng": np.random.Generator |
        None}. Results equal per-query retrieve calls (each query's rng
        drives its shuffles)."""
        Q = len(queries)
        if Q == 0:
            return []
        with spans.span("engine.retrieve_batch"):
            with spans.span("engine.plan"):
                plan_idx = self._stage2_win_idx(len(features))
                feats_dev = self._features_to_device(features, movie_key)
                per_q = []
                for q in queries:
                    gw = q.get("grounding_windows")
                    win_idx = plan_idx
                    if gw is None:
                        gw = list(range(len(plan_idx)))
                    else:
                        win_idx = plan_idx[np.asarray(gw, np.int32)]
                    rng = q.get("rng") or np.random.default_rng(42)
                    per_q.append((gw, len(win_idx)) + self._stage2_passes(win_idx, rng))

                num_videos = per_q[0][6][0].shape[0] if per_q[0][6] else self.eval_cfg.batch
                ids_list = [self._prompt_ids(q["sentence"], QUESTIONS[question_key])
                            for q in queries]
                max_len = (max(len(i) for i in ids_list) - 1 + num_videos
                           + self.eval_cfg.max_new_tokens)
                plans = [build_splice_plan(ids, num_videos, max_len) for ids in ids_list]
                qf_all, qv_all = self._query_feats_stack(queries, features.shape[-1],
                                                         "retrieve_batch")
            spans.note(windows=sum(p[1] for p in per_q))

            flat_rows: List[np.ndarray] = []
            flat_q: List[int] = []
            for qi, p in enumerate(per_q):
                flat_rows.extend(p[6])
                flat_q.extend([qi] * len(p[6]))
            answers, mean_e, max_e = self._run_stage2_rows(
                flat_rows, plans, flat_q, feats_dev, qf_all, qv_all, qsel=qf_all is not None)

            results = []
            off = 0
            for qi, (gw, V, starts, indexes, zooms, calls, row_idx) in enumerate(per_q):
                k = len(row_idx)
                results.append(self._stage2_finalize(
                    answers[off : off + k], mean_e[off : off + k], max_e[off : off + k], starts,
                    indexes, zooms, calls, row_idx, gw, V, feats_dev, queries[qi].get("query_cls"),
                ))
                off += k
            return results

    # ------------------------------------------------------------- t2v eval

    def retrieve_videos(
        self,
        video_feats: np.ndarray,
        sentence: str,
        query_feats: Optional[np.ndarray] = None,
        query_cls: Optional[np.ndarray] = None,
        question_key: str = "retrieval",
        corpus_key=None,
    ) -> Dict[str, Any]:
        """Text-to-video retrieval over a candidate corpus (MSR-VTT style):
        candidates play the part stage-2 windows play. Each pass shows
        eval_cfg.batch candidate tracks as one CLS token each (the tail pass
        starts at V - batch); its 'In video N' answer maps back to a
        candidate (_map_retrieval_answers), scored by inverse mean entropy,
        times the query-CLS cosine (normalized by its largest magnitude)
        when `query_cls` is given.

        video_feats [V, T, d], each candidate already linspace-sampled to
        num_frames (reference dataset.py:661-666). The corpus stays on the
        device under `corpus_key` across a query loop. Returns answers per
        pass, the chosen candidates ranked by score, their scores and V."""
        ecfg = self.eval_cfg
        V, T, d = video_feats.shape
        batch = max(ecfg.batch, 1)
        with spans.span("engine.retrieve_videos", windows=V):
            with spans.span("engine.plan"):
                feats_dev = self._features_to_device(video_feats.reshape(V * T, d), corpus_key)
                base_idx = np.arange(V * T, dtype=np.int32).reshape(V, T)
                ids = self._prompt_ids(sentence, QUESTIONS[question_key])
                plan_np = stack_plans([build_splice_plan(ids, batch, len(ids) - 1 + batch
                                                         + ecfg.max_new_tokens)])
                qf = qv = None
                if query_feats is not None:
                    qf, qv = self._broadcast_query_feats(query_feats, 1)
            starts: List[int] = []
            pending = []
            for p in range(int(np.ceil(V / batch))):
                start = min(p * batch, max(V - batch, 0))
                starts.append(start)
                rows = base_idx[start : start + batch]
                if len(rows) < batch:
                    rows = np.concatenate([rows, np.repeat(rows[-1:], batch - len(rows), axis=0)])
                pending.append(self._run_chunk(plan_np, rows[None], feats_dev, qf, qv, 1))
            answers: List[str] = []
            inv_entropy: List[float] = []
            for out in pending:
                chunk_answers, stats = self._read_chunk(out)
                answers.append(chunk_answers[0])
                inv_entropy.append(1.0 / max(stats[0, 2], 1e-9))

            with spans.span("engine.finalize"):
                chosen, scores = _map_retrieval_answers(answers, inv_entropy, starts, batch, V)
                if query_cls is not None and chosen:
                    cand = torch.as_tensor(chosen, dtype=torch.long, device=self.device)
                    frames = feats_dev.reshape(V, T, d)[cand]
                    valid = torch.ones(frames.shape[:2], dtype=torch.bool, device=self.device)
                    qc = torch.as_tensor(np.asarray(query_cls), dtype=torch.float32,
                                         device=self.device)
                    cos = proposal_cosine_scores(qc, frames, valid, k=3).tolist()
                    m = max(abs(c) for c in cos) or 1.0
                    scores = [s * (c / m) for s, c in zip(scores, cos)]

                order = np.argsort(np.asarray(scores))[::-1] if scores else []
                return {
                    "answers": answers,
                    "ranked": [chosen[i] for i in order],
                    "scores": [scores[i] for i in order],
                    "num_candidates": V,
                }
