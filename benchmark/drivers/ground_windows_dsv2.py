"""Driver of stage-1 grounding on DeepSeek-V2: ground_windows.Driver with
the model built as a DeepseekV2Config (MLA, DeepSeekMoE, YaRN) and its
weights from benchlib.weights_dsv2; the queries, the window, the checks
and the recording engine are ground_windows'. The traced queries also keep
the rows routed to each expert in every MoE layer of every decode step,
as the program's own dispatch counted them (models/generation.py
mla_decode_counts: the decode graphs' buffers, copied after each query),
under "moe_counts": [counts [E]] by step and then layer; the bound of
moe_k1_roofline reads them, so it follows the program's routing.

The program gets the seed's draws and makes its serving tree from them
with its own quantizer (ops/quant.py quantize_int8, per output channel)
and layouts (models/llama.py add_mla_layouts). The control (fmt "int4")
rounds every matrix per output channel to 4 bits (absmax / 7, codes in
[-7, 7]) and serves those codes as int8 through the same kernels."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchlib import traffic as TR
from benchlib import weights as Wt
from benchlib import weights_dsv2 as W2
from benchlib.cell import module
from benchlib.tokenizer import EOS, Tokenizer

base = module("drivers", "ground_windows")


def quantized(w: torch.Tensor, fmt: str):
    """{"q8", "scale"} of w [..., in, out] per output channel: the
    program's int8 quantizer, or 4-bit codes (absmax / 7) held as int8."""
    from revisionllm_tpu_torch.ops import quant

    if fmt == "int8":
        q, s = quant.quantize_int8(w)
        return {"q8": q, "scale": s}
    amax = w.abs().amax(dim=-2)
    s = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    return {"q8": torch.clamp(torch.round(w / s.unsqueeze(-2)), -7, 7).to(torch.int8), "scale": s}


def model_config(dims, dtype: str):
    from revisionllm_tpu_torch.config import DeepseekV2Config

    d = dims
    return DeepseekV2Config(
        vocab_size=d["vocab"], hidden_size=d["hidden"], intermediate_size=d["ffn"],
        num_layers=d["layers"], num_heads=d["heads"], num_kv_heads=d["heads"],
        head_dim=d["v_head"], rope_theta=d["rope_theta"], rms_norm_eps=d["eps"], dtype=dtype,
        kv_lora_rank=d["kv_lora"], qk_nope_head_dim=d["qk_nope"], qk_rope_head_dim=d["qk_rope"],
        v_head_dim=d["v_head"], n_routed_experts=d["experts"], n_shared_experts=d["shared"],
        num_experts_per_tok=d["top_k"], moe_intermediate_size=d["moe_ffn"],
        first_k_dense_replace=d["dense_layers"], rope_scaling_factor=d["rope_factor"],
        rope_original_max_position=d["rope_original"], yarn_beta_fast=d["beta_fast"],
        yarn_beta_slow=d["beta_slow"], yarn_mscale=d["mscale"],
        yarn_mscale_all_dim=d["mscale_all_dim"])


def program_params(cfg, dims, seed: int, device, fmt: str = "int8"):
    """The program's serving tree from the seed's draws, a layer at a time."""
    from revisionllm_tpu_torch.models.llama import add_mla_layouts

    L, k = dims["layers"], dims["dense_layers"]
    layers: Dict[str, object] = {}
    dense: Dict[str, object] = {}
    moe: Dict[str, object] = {}

    def put(tree, name, i, n, leaf):
        if isinstance(leaf, dict):
            sub = tree.setdefault(name, {})
            for key, t in leaf.items():
                put(sub, key, i, n, t)
            return
        if name not in tree:
            tree[name] = torch.empty((n,) + tuple(leaf.shape), dtype=leaf.dtype, device=device)
        tree[name][i] = leaf

    for i in range(L):
        for name, w in W2.layer_attention(dims, seed, i, device).items():
            put(layers, name, i, L, quantized(w, fmt))
        for name, v in W2.layer_vectors(dims, seed, i, device).items():
            put(layers, name, i, L, v)
        for name, w in W2.layer_mlp(dims, seed, i, device).items():
            if W2.is_dense(dims, i):
                put(dense, name, i, k, quantized(w, fmt))
            else:
                put(moe, name, i - k, L - k, w if name == "router" else quantized(w, fmt))
        del w
    params = {
        "embed": Wt.embed(dims, seed, device),
        "layers": layers,
        "dense": dense,
        "moe": {"router": moe.pop("router"),
                "experts": {"gu": moe.pop("gu"), "down": moe.pop("down")}, **moe},
        "final_norm": Wt.final_norm(dims, seed, device),
        "lm_head": quantized(Wt.lm_head(dims, seed, device), fmt),
    }
    return add_mla_layouts(cfg, params)


class Driver(base.Driver):
    def traced(self, n: int):
        from revisionllm_tpu_torch.models import generation

        out = []
        for _ in range(n):
            rec = self.query(next(self.stream))
            rec["moe_counts"] = [c.clone() for step in
                                 generation.mla_decode_counts(self.engine.params) for c in step]
            out.append(rec)
        return out

    def check(self, records, check_seed: int):
        """ground_windows' numbers, the sample drawn as there, and moe_gap:
        the widest gap of the program's routed experts (ops/moe.py
        routed_experts, its dispatch, grouped kernels and combine) from the
        reference's, given the same rows and routing, over every MoE layer
        of the reference's pass (references/revisionllm_dsv2.py moe_gap).
        The program's experts are kept through the release; the rest of
        its state is freed first."""
        from revisionllm_tpu_torch.models.llama import tree_at
        from revisionllm_tpu_torch.ops import moe as MOE

        experts, k = self.engine.params["moe"]["experts"], self.llama_cfg.first_k_dense_replace

        def program(i, h, w, idx):
            with torch.no_grad():
                return MOE.routed_experts(h, tree_at(experts, i - k), w, idx)[0]

        bad = sum(self.malformed(r) for r in records)
        k_q = min(self.mix["check_queries"], len(records))
        longest = max(range(len(records)), key=lambda i: (records[i]["live"], -i))
        rest = [i for i in range(len(records)) if i != longest]
        rng = np.random.default_rng(Wt.sub_seed(check_seed, "check"))
        pick = [longest] + sorted(rng.choice(rest, k_q - 1, replace=False).tolist() if k_q > 1
                                  else [])
        sampled = []
        for i in pick:
            r, w = records[i], records[i]["windows"]
            q = r["query"]
            sampled.append({"sentence": q.sentence, "movie": self.movies[q.movie],
                            "query_feats": q.query_feats, "tokens": r["tokens"][:w],
                            "valid": r["valid"][:w], "entropy": r["entropy"][:w]})
        self.release()
        ref = module("references", self.cell["config"]["reference"])
        got = ref.served_logit_readings(self.cell, self.seed, self.device, sampled, program)
        del experts
        prog_ent = np.concatenate([s["entropy"][s["valid"]] for s in sampled]).astype(np.float64)
        return {
            "malformed_queries": float(bad),
            "logit_gap": float(got["gap"].max()),
            "entropy_gap": float(np.abs(prog_ent - got["entropy"]).max()),
            "moe_gap": float(got["moe_gaps"].max()),
            "served_tokens_judged": float(len(got["gap"])),
        }

    def setup(self, warm: bool = True):
        from revisionllm_tpu_torch.config import AdapterConfig, EvalConfig
        from revisionllm_tpu_torch.models import generation
        from revisionllm_tpu_torch.ops import quant

        serving = self.cell["config"]["serving"]
        quant.set_w8a8(bool(serving["w8a8_prefill"]))
        generation.set_kv8(bool(serving["kv8_prompt_cache"]))
        d, a, ev = self.dims, self.cell["adapter"], self.mix["eval"]
        self.llama_cfg = model_config(d, serving["dtype"])
        acfg = AdapterConfig(
            kind=a["kind"], d_model=a["d_model"], num_heads=a["num_heads"],
            num_layers=a["num_layers"], ffn_dim=a["ffn_dim"], hidden_size=d["hidden"],
            clip_adapter_text=a["clip_adapter_text"], hierarchy=False,
            feature_mode=a["feature_mode"])
        params = program_params(self.llama_cfg, d, self.seed, self.device, self.fmt)
        vision = {"mm_projector": Wt.adapter(a, d["hidden"], self.seed, self.device)}
        self.engine = base._recording_engine()(self.llama_cfg, acfg, params, vision, Tokenizer(),
                                               EvalConfig(**ev), eos_id=EOS, device=self.device)
        self.engine.captured = []
        self.movies = [TR.movie_features(self.mix, self.seed, m, self.device)
                       for m in range(self.mix["movies"])]
        self.stream = TR.queries(self.mix, self.seed)
        if warm:
            for q in TR.warmup_queries(self.mix, self.seed):
                self.query(q)
        self.sync()
