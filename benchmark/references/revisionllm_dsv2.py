"""Plain reference of the ReVisionLLM stage-1 stack on DeepSeek-V2, in
float32: the adapter and the splice of references/revisionllm.py, then
DeepSeek-V2's decoder (modeling_deepseek.py) over the prompt and the served
tokens in one causal pass: multi-head latent attention decompressed (the
latent, its RMSNorm, k_nope and v from kv_b_proj, YaRN on the rope part in
interleaved pairs, the softmax scale 192^-0.5 m^2), layer 0's dense SwiGLU,
and DeepSeekMoE (the router in f32 over the same f32 weights, softmax, greedy
top-6, each token through the experts it chose only, plus the shared
experts). The int8 weights the configuration serves are worked out again
from the seed's draws; no kernel, cache, batching or quantized activation:
every product is an f32 matmul with TF32 off.

It imports torch, numpy and the benchmark's own inputs (benchlib), and the
adapter from references/revisionllm.py; nothing of the program. Layer by
layer, a layer's weights drawn again and freed after it.

A near tie of the router changes a token's top-6 set on a rounding: the
number of (layer, position) whose 6th and 7th scores lie within 1e-4 is
printed to standard error, where a run that is not `correct` can be read
for a top-6 set that differs from the program's.

The routed experts alone carry a small share of a token's logits at random
weights (their router weights are softmax scores over 64 experts), so a
fault in part of the expert path hides in the logits. Given the program's
routed experts (drivers/ground_windows_dsv2.py passes them), every MoE
layer's are also compared with the reference's on the same rows and
routing (`moe_gap`)."""

from __future__ import annotations

import math
import sys
from typing import Dict, List

import numpy as np
import torch

from benchlib import weights as Wt
from benchlib import weights_dsv2 as W2
from benchlib.cell import module
from benchlib.prompt import VIDEO, grounding_prompt_ids

R1 = module("references", "revisionllm")
ROW_BLOCK = R1.ROW_BLOCK
NEAR_TIE = 1e-4
SPREAD = 7919   # a prime: the decode-sized sample's positions, r * SPREAD mod its length


def int8_weight(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel absmax int8 of f32 [..., in, out], dequantized."""
    amax = w.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(w / scale), -127, 127) * scale


def yarn(dims):
    """(inverse frequencies [rope / 2], the tables' factor, the softmax
    scale) of DeepseekV2YarnRotaryEmbedding and DeepseekV2Attention."""
    dim, base, f = dims["qk_rope"], dims["rope_theta"], dims["rope_factor"]

    def mscale(m):
        return 1.0 if f <= 1 else 0.1 * m * math.log(f) + 1.0

    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    inv = 1.0 / base ** exps
    if f > 1:
        def corr(rot):
            return dim * math.log(dims["rope_original"] / (rot * 2 * math.pi)) / (
                2 * math.log(base))

        lo = max(math.floor(corr(dims["beta_fast"])), 0)
        hi = min(math.ceil(corr(dims["beta_slow"])), dim - 1)
        hi = hi + 0.001 if lo == hi else hi
        keep = 1.0 - torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - lo) / (hi - lo),
                                 0, 1)
        inv = inv / f * (1 - keep) + inv * keep
    m = mscale(dims["mscale_all_dim"]) if dims["mscale_all_dim"] else 1.0
    scale = (dims["qk_nope"] + dim) ** -0.5 * m * m
    return inv, mscale(dims["mscale"]) / (mscale(dims["mscale_all_dim"])
                                          if dims["mscale_all_dim"] else 1.0), scale


def _rope(x, pos, inv, factor):
    """x [b, S, h, r] rotated in (even, odd) pairs at positions pos [b, S]."""
    ang = (pos.double()[..., None] * inv.to(x.device).double()).float()[:, :, None, :]
    c, s = torch.cos(ang) * factor, torch.sin(ang) * factor
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x0 * c - x1 * s, x1 * c + x0 * s], -1).flatten(-2)


def attention(x, pos, W, vec, dims, rope):
    """MLA decompressed over x [B, S, D] (causal)."""
    B, S, _ = x.shape
    H, C, dn, dr, dv = (dims["heads"], dims["kv_lora"], dims["qk_nope"], dims["qk_rope"],
                        dims["v_head"])
    inv, factor, scale = rope
    q = (x @ W["q_proj"]).view(B, S, H, dn + dr)
    ckv = x @ W["kv_a_proj"]
    c = R1._rms(ckv[..., :C], vec["kv_a_norm"], dims["eps"])
    k_pe = _rope(ckv[..., C:].view(B, S, 1, dr), pos, inv, factor)
    kv = (c @ W["kv_b_proj"]).view(B, S, H, dn + dv)
    q = torch.cat([q[..., :dn], _rope(q[..., dn:], pos, inv, factor)], -1)
    k = torch.cat([kv[..., :dn], k_pe.expand(B, S, H, dr)], -1)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, kv[..., dn:]).reshape(B, S, H * dv)
    return o @ W["o_proj"]


def _swiglu(x, gate, up, down):
    g = x @ gate
    return (g * torch.sigmoid(g) * (x @ up)) @ down


def routed(h, w, idx, M, dims):
    """The routed experts' part of DeepseekV2MoE over h [N, D] with the
    routing (w, idx) [N, top_k]: each token through the experts it chose
    only, weighted."""
    Fm = dims["moe_ffn"]
    y = torch.zeros_like(h)
    for e in range(dims["experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if not len(tok):
            continue
        gu = h[tok] @ M["gu"][e]
        out = (gu[:, :Fm] * torch.sigmoid(gu[:, :Fm]) * gu[:, Fm:]) @ M["down"][e]
        y.index_add_(0, tok, out * w[tok, slot][:, None])
    return y


def moe_gap(h, w, idx, M, dims, program) -> float:
    """The program's routed experts (`program(h, w, idx)`, its own
    dispatch, kernels and combine) against `routed` on the same rows h
    [N, D] rounded to bfloat16 (the program's activations) and the same
    routing: the widest distance of a row, over the mean norm of the
    reference's rows."""
    hb = h.to(torch.bfloat16)
    want = routed(hb.float(), w, idx, M, dims)
    got = program(hb, w, idx).float()
    return float((got - want).norm(dim=-1).max() / want.norm(dim=-1).mean())


def moe(h, M, dims, ties, probe=None):
    """DeepseekV2MoE over h [N, D]: only the experts each token chose.
    probe (program, the rows of the decode-sized sample, the gaps' list):
    the program's routed experts compared on every row (the prefill's
    number of rows) and on the sample (a decode step's), each gap appended."""
    scores = torch.softmax(h @ M["router"], -1)
    top = torch.topk(scores, dims["top_k"] + 1, dim=-1)
    ties[0] += int((top.values[:, -2] - top.values[:, -1] < NEAR_TIE).sum())
    w, idx = top.values[:, :-1], top.indices[:, :-1]
    if dims["norm_topk"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * dims["routed_scaling"]
    if probe is not None:
        program, sample, gaps = probe
        gaps.append(moe_gap(h, w, idx, M, dims, program))
        gaps.append(moe_gap(h[sample], w[sample], idx[sample], M, dims, program))
    return routed(h, w, idx, M, dims) + _swiglu(h, M["shared_gate"], M["shared_up"],
                                                 M["shared_down"])


def decoder_layer(x, pos, i, seed, dims, rope, ties, probe=None):
    B, S, D = x.shape
    dev = x.device
    W = {n: int8_weight(m) for n, m in W2.layer_attention(dims, seed, i, dev).items()}
    vec = {n: t.float() for n, t in W2.layer_vectors(dims, seed, i, dev).items()}
    h = R1._rms(x, vec["attn_norm"], dims["eps"])
    x = x + torch.cat([attention(h[b:b + ROW_BLOCK], pos[b:b + ROW_BLOCK], W, vec, dims, rope)
                       for b in range(0, B, ROW_BLOCK)])
    del W
    h = R1._rms(x, vec["mlp_norm"], dims["eps"])
    M = {n: m if n == "router" else int8_weight(m)
         for n, m in W2.layer_mlp(dims, seed, i, dev).items()}
    if W2.is_dense(dims, i):
        return x + _swiglu(h, M["gate_proj"], M["up_proj"], M["down_proj"])
    if probe is not None:
        program, sample, gaps = probe
        probe = (lambda hb, w, idx: program(i, hb, w, idx), sample, gaps)
    return x + moe(h.reshape(-1, D), M, dims, ties, probe).view(B, S, D)


def served_logit_readings(cell, seed: int, device, sampled: List[Dict], program=None):
    """As references/revisionllm.py's: for each sampled query's served
    tokens, the reference's logits given the prompt and the tokens before;
    {"gap": ref best minus the served token's logit, "entropy": the
    reference's entropy}, over the valid positions in order. With
    `program(layer, h, w, idx)` (the program's routed experts of that
    layer) also "moe_gaps": `moe_gap` at every MoE layer over every row
    of the pass, and over a decode-sized sample, a position of each
    sequence (the windows of a query route much alike, so positions that
    differ make an expert's rows differ)."""
    R1.f32_matmuls()
    dims, acfg, ev = cell["dims"], cell["adapter"], cell["traffic"]["eval"]
    D, V, G = dims["hidden"], dims["vocab"], ev["max_new_tokens"]
    nf = ev["num_frames"]
    with torch.no_grad():
        tree = R1._to_f32(Wt.adapter(acfg, D, seed, device))
        embed = Wt.embed(dims, seed, device)
        xs, lens, served = [], [], []
        for q in sampled:
            idx = torch.as_tensor(R1.window_frames(len(q["movie"]), ev), device=device).long()
            nw = len(idx)
            movie = torch.as_tensor(q["movie"], device=device)
            text = torch.as_tensor(q["query_feats"], device=device)
            vids = torch.cat([R1.adapter_forward(tree, acfg, movie[rows], text.expand(
                len(rows), *text.shape)) for rows in idx.split(ROW_BLOCK)])
            ids = grounding_prompt_ids(q["sentence"])
            cut = ids.index(VIDEO)
            before = embed[torch.as_tensor(ids[:cut], device=device)].float()
            after = embed[torch.as_tensor(ids[cut + 1:], device=device)].float()
            toks = torch.as_tensor(np.asarray(q["tokens"])[:nw], device=device).long().clamp(
                0, V - 1)
            for r in range(nw):
                xs.append(torch.cat([before, vids[r], after, embed[toks[r, : G - 1]].float()]))
                lens.append(len(ids) - 1 + nf)
            served.append((toks, np.asarray(q["valid"])[:nw]))
        S = max(x.shape[0] for x in xs)
        x = torch.stack([torch.nn.functional.pad(t, (0, 0, 0, S - t.shape[0])) for t in xs])
        del xs
        pos = torch.arange(S, device=device)[None].expand(x.shape[0], S)
        rope = yarn(dims)
        ties = [0]
        probe = None
        if program is not None:
            # a position a sequence, spread over its prompt and served tokens
            n = torch.as_tensor(lens, device=device) + G - 1
            r = torch.arange(len(lens), device=device)
            probe = (program, r * S + (r * SPREAD) % n, [])
        for i in range(dims["layers"]):
            x = decoder_layer(x, pos, i, seed, dims, rope, ties, probe)
        print(f"# reference: {ties[0]} (layer, position) pairs whose 6th and 7th router scores "
              f"lie within {NEAR_TIE}", file=sys.stderr, flush=True)
        h = R1._rms(x, Wt.final_norm(dims, seed, device).float(), dims["eps"])
        head = int8_weight(Wt.lm_head(dims, seed, device))
        lens_t = torch.as_tensor(lens, device=device)
        at = (lens_t[:, None] - 1 + torch.arange(G, device=device)[None])
        hs = h[torch.arange(h.shape[0], device=device)[:, None], at]
        gaps, ents = [], []
        r0 = 0
        for toks, valid in served:
            for r in range(toks.shape[0]):
                logits = (hs[r0 + r] @ head).double()
                best = logits.max(-1).values
                gap = best - logits.gather(1, toks[r][:, None])[:, 0]
                p = torch.softmax(logits, -1)
                ent = -(p * torch.log(p + 1e-10)).sum(-1)
                keep = torch.as_tensor(valid[r], device=device)
                gaps.append(gap[keep].cpu().numpy())
                ents.append(ent[keep].cpu().numpy())
            r0 += toks.shape[0]
    out = {"gap": np.concatenate(gaps), "entropy": np.concatenate(ents)}
    if probe is not None:
        out["moe_gaps"] = np.asarray(probe[2])
    return out
