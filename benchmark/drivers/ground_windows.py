"""Driver of the stage-1 grounding mixes: GroundingEngine.ground_windows,
one query at a time from one client in a closed loop, as eval/stage1.py
--query_batch 1 runs it.

The program gets the seed's weights (benchlib.weights) and derives its
own serving weights from them with its quantizers (ops/quant.py); the
plain reference (references/<config's reference>.py) works them out
again. The engine's outputs are observed by a subclass that keeps each
chunk's tokens, validity and per-step entropies as `_read_chunk` reads
them back; nothing of the engine's work changes."""

from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np
import torch

from benchlib import traffic as TR
from benchlib import weights as Wt
from benchlib.cell import module
from benchlib.prompt import grounding_prompt_ids
from benchlib.tokenizer import EOS, Tokenizer


def program_params(dims, seed: int, device, fmt: str = "int8"):
    """The program's weight tree from the seed's draws, each matrix turned
    into int8 (or int4, the control's) by the program's own quantizer, one
    layer at a time."""
    from revisionllm_tpu_torch.ops import quant

    L = dims["layers"]
    layers: Dict[str, object] = {}

    def quantized(w):
        if fmt == "int8":
            q, s = quant.quantize_int8(w)
            return {"q8": q, "scale": s}
        q, s = quant.quantize_int4(w)
        return {"q4": q, "scale4": s}

    for i in range(L):
        for name, w in Wt.layer_matrices(dims, seed, i, device).items():
            leaf = quantized(w)
            if name not in layers:
                layers[name] = {k: torch.empty((L,) + tuple(t.shape), dtype=t.dtype,
                                               device=device) for k, t in leaf.items()}
            for k, t in leaf.items():
                layers[name][k][i] = t
            del leaf
        for name, v in Wt.layer_vectors(dims, seed, i, device).items():
            if name not in layers:
                layers[name] = torch.empty((L,) + tuple(v.shape), dtype=v.dtype, device=device)
            layers[name][i] = v
    return {
        "embed": Wt.embed(dims, seed, device),
        "layers": layers,
        "final_norm": Wt.final_norm(dims, seed, device),
        "lm_head": quantized(Wt.lm_head(dims, seed, device)),
    }


def _recording_engine():
    from revisionllm_tpu_torch.eval.engine import GroundingEngine

    class RecordingEngine(GroundingEngine):
        """GroundingEngine that keeps what each chunk served."""

        def _read_chunk(self, out):
            res = super()._read_chunk(out)
            self.captured.append({"tokens": out["tokens"].cpu().numpy(),
                                  "valid": out["valid"].cpu().numpy(),
                                  "entropy": out["entropy"].float().cpu().numpy()})
            return res

    return RecordingEngine


class Driver:
    def __init__(self, cell, seed: int, device, fmt: str = "int8"):
        self.cell, self.seed, self.device, self.fmt = cell, seed, torch.device(device), fmt
        self.mix = cell["traffic"]
        self.dims = cell["dims"]
        self.engine = None

    # ------------------------------------------------------------ set-up

    def setup(self, warm: bool = True):
        from revisionllm_tpu_torch.config import AdapterConfig, EvalConfig, LlamaConfig
        from revisionllm_tpu_torch.models import generation
        from revisionllm_tpu_torch.ops import quant

        serving = self.cell["config"]["serving"]
        quant.set_w8a8(bool(serving["w8a8_prefill"]))
        generation.set_kv8(bool(serving["kv8_prompt_cache"]))
        d, a, ev = self.dims, self.cell["adapter"], self.mix["eval"]
        self.llama_cfg = LlamaConfig(
            vocab_size=d["vocab"], hidden_size=d["hidden"], intermediate_size=d["ffn"],
            num_layers=d["layers"], num_heads=d["heads"], num_kv_heads=d["kv_heads"],
            head_dim=d["head_dim"], rope_theta=d["rope_theta"], rms_norm_eps=d["eps"],
            dtype=serving["dtype"], rope_fraction=d["rope_fraction"],
            rope_interleaved=d["rope_interleaved"], qkv_bias=d["qkv_bias"])
        acfg = AdapterConfig(
            kind=a["kind"], d_model=a["d_model"], num_heads=a["num_heads"],
            num_layers=a["num_layers"], ffn_dim=a["ffn_dim"], hidden_size=d["hidden"],
            clip_adapter_text=a["clip_adapter_text"], hierarchy=False,
            feature_mode=a["feature_mode"])
        ecfg = EvalConfig(**ev)
        params = program_params(d, self.seed, self.device, self.fmt)
        vision = {"mm_projector": Wt.adapter(a, d["hidden"], self.seed, self.device)}
        self.engine = _recording_engine()(self.llama_cfg, acfg, params, vision, Tokenizer(),
                                          ecfg, eos_id=EOS, device=self.device)
        self.engine.captured = []
        self.movies = [TR.movie_features(self.mix, self.seed, m, self.device)
                       for m in range(self.mix["movies"])]
        self.stream = TR.queries(self.mix, self.seed)
        if warm:
            for q in TR.warmup_queries(self.mix, self.seed):
                self.query(q)
        self.sync()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ queries

    def query(self, q: TR.Query) -> Dict:
        """One query, from its submission to its finalized result; returns
        its record (latency, shapes, what it served)."""
        ev = self.mix["eval"]
        self.engine.captured = []
        t0 = time.perf_counter()
        res = self.engine.ground_windows(self.movies[q.movie], q.sentence, q.query_feats,
                                         q.query_cls, question_key=self.mix["question"],
                                         movie_key=f"movie{q.movie}")
        self.sync()
        lat = time.perf_counter() - t0
        n_ids = len(grounding_prompt_ids(q.sentence, self.mix["question"]))
        live = n_ids - 1 + ev["num_frames"]
        cap = self.engine.captured
        return {
            "query": q, "latency_s": lat, "windows": int(res["num_windows"]),
            "answers": len(res["answers"]), "rows": ev["batch"], "live": live,
            "T": live + ev["max_new_tokens"], "text_tokens": len(q.query_feats),
            "tokens": np.concatenate([c["tokens"] for c in cap]),
            "valid": np.concatenate([c["valid"] for c in cap]),
            "entropy": np.concatenate([c["entropy"] for c in cap]),
        }

    def window(self, seconds: float):
        """Queries back to back until `seconds` have passed since the first
        was submitted; the last one started ends the window. Returns
        (records, window seconds)."""
        records = []
        self.sync()
        t0 = time.perf_counter()
        while True:
            records.append(self.query(next(self.stream)))
            if time.perf_counter() - t0 >= seconds:
                break
        return records, time.perf_counter() - t0

    def traced(self, n: int):
        return [self.query(next(self.stream)) for _ in range(n)]

    def end_to_end(self, records, window_s) -> Dict[str, float]:
        lat = np.asarray([r["latency_s"] for r in records])
        return {"queries_per_s": len(records) / window_s,
                "query_ms_p95": float(np.percentile(lat * 1e3, 95))}

    # ------------------------------------------------------------ checks

    def release(self):
        self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def malformed(self, r) -> bool:
        """A query whose result is not whole: fewer answers than windows,
        a token outside the vocabulary, a non-finite entropy."""
        w = r["windows"]
        tok, ent = r["tokens"][:w], r["entropy"][:w]
        return (r["answers"] != w or w == 0 or (tok < 0).any() or (tok >= self.dims["vocab"]).any()
                or not np.isfinite(ent).all())

    def check(self, records, check_seed: int):
        """The numbers that decide `correct`: every query's shape, then a
        sample of the finished queries, drawn from the seed with the one of
        the longest prompt in it, judged by the plain reference at every
        served token: the widest gap by which a served token's logit lies
        below the reference's best, and the widest difference of a step's
        entropy from the reference's. The program's state is freed first."""
        bad = sum(self.malformed(r) for r in records)
        k = min(self.mix["check_queries"], len(records))
        longest = max(range(len(records)), key=lambda i: (records[i]["live"], -i))
        rest = [i for i in range(len(records)) if i != longest]
        rng = np.random.default_rng(Wt.sub_seed(check_seed, "check"))
        pick = [longest] + sorted(rng.choice(rest, k - 1, replace=False).tolist() if k > 1
                                  else [])
        sampled = []
        for i in pick:
            r = records[i]
            q = r["query"]
            sampled.append({"sentence": q.sentence, "movie": self.movies[q.movie],
                            "query_feats": q.query_feats, "tokens": r["tokens"][: r["windows"]],
                            "valid": r["valid"][: r["windows"]],
                            "entropy": r["entropy"][: r["windows"]]})
        self.release()
        ref = module("references", self.cell["config"]["reference"])
        got = ref.served_logit_readings(self.cell, self.seed, self.device, sampled)
        prog_ent = np.concatenate([s["entropy"][s["valid"]] for s in sampled]).astype(np.float64)
        return {
            "malformed_queries": float(bad),
            "logit_gap": float(got["gap"].max()),
            "entropy_gap": float(np.abs(prog_ent - got["entropy"]).max()),
            "served_tokens_judged": float(len(got["gap"])),
        }
