"""Plain reference of the ReVisionLLM stage-1 stack, in float32: the T2V
ClipEncoder adapter, the splice of its frame tokens into the prompt, and
the Llama / ChatGLM2 decoder over the prompt and the served tokens in one
causal pass (teacher forcing), with the int8 weights that the configuration
serves worked out again from the seed's draws. No kernel, cache, batching
or quantized activation: every product is an f32 matmul with TF32 off.

It imports torch, numpy and the benchmark's own inputs (benchlib: weights,
tokenizer, prompt), nothing of the program. It runs layer by layer over all
the rows it judges, drawing each layer's weights again, so that only one
layer's f32 weights exist at a time."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from benchlib import weights as Wt
from benchlib.prompt import VIDEO, grounding_prompt_ids

ROW_BLOCK = 16          # rows a block in the attention and the adapter


def f32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def int8_weight(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel absmax int8 of an f32 [in, out] matrix, rounded
    half to even and dequantized: the weights the configuration serves."""
    amax = w.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(w / scale), -127, 127) * scale


def window_frames(ctx: int, ev) -> np.ndarray:
    """[windows, num_frames] frame indices of stage 1's dense windows: half
    overlapping windows of debug_window seconds, num_frames spread evenly
    over each (truncated), the last window cut at the movie's end."""
    clip = int(ev["debug_window"] * ev["feature_fps"])
    n = math.ceil(ctx / (clip // 2)) - 1
    return np.stack([np.linspace(i * (clip // 2), min(i * (clip // 2) + clip, ctx - 1),
                                 ev["num_frames"], dtype=np.int32) for i in range(n)])


# ------------------------------------------------------------------ adapter

def _ln(x, w, b, eps=1e-5):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) / torch.sqrt(v + eps) * w + b


def _lin(p, x):
    return x @ p["w"] + p["b"]


def _mha(p, q_in, k_in, v_in, heads):
    B, Lq, d = q_in.shape
    hd = d // heads
    q = _lin(p["wq"], q_in).view(B, Lq, heads, hd)
    k = _lin(p["wk"], k_in).view(B, -1, heads, hd)
    v = _lin(p["wv"], v_in).view(B, -1, heads, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v).reshape(B, Lq, d)
    return _lin(p["wo"], o)


def _ffn(p, x):
    return _lin(p["ffn2"], torch.relu(_lin(p["ffn1"], x)))


def sine_positions(n: int, d: int, device) -> torch.Tensor:
    """DETR's normalized 1-D sine embedding of positions 1..n: channel 2i
    sin and 2i + 1 cos of (pos / n * 2 pi) / 10000^(2i / d)."""
    x = torch.arange(1, n + 1, dtype=torch.float64, device=device) / (n + 1e-6) * 2 * math.pi
    i = torch.arange(d, dtype=torch.float64, device=device)
    a = x[:, None] / 10000 ** (2 * torch.floor(i / 2) / d)
    return torch.where(i % 2 == 0, torch.sin(a), torch.cos(a)).float()


def adapter_forward(tree, acfg, video: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
    """ClipEncoder with T2V: video [B, T, d], text [B, t, d] (f32) ->
    frame tokens [B, T, hidden]. The T2V layers let the frames attend to
    the text tokens (position added to the frames' queries and the CLS, not
    to the text), then LayerNorm -> FFN -> residual -> LayerNorm on the
    frames; the encoder layers are post-norm self-attention over CLS +
    frames with the positions added to queries and keys."""
    B, T, d = video.shape
    heads = acfg["num_heads"]
    pos = torch.cat([tree["global_pos"][None], sine_positions(T, d, video.device)])[None]
    src = torch.cat([tree["global_token"].expand(B, 1, d), video], 1)
    if acfg["clip_adapter_text"]:
        for p in tree["t2v_layers"]:
            frames = src[:, 1:] + _mha(p, (src + pos)[:, 1:], text, text, heads)
            h = _ln(frames, p["norm1_w"], p["norm1_b"])
            frames = _ln(frames + _ffn(p, h), p["norm2_w"], p["norm2_b"])
            src = torch.cat([src[:, :1], frames], 1)
    for p in tree["enc_layers"]:
        qk = src + pos
        src = _ln(src + _mha(p, qk, qk, src, heads), p["norm1_w"], p["norm1_b"])
        src = _ln(src + _ffn(p, src), p["norm2_w"], p["norm2_b"])
    return _lin(tree["mm_projector"], src[:, 1:])


# ------------------------------------------------------------------ decoder

def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x, pos, dims):
    """x [b, S, h, hd] rotated at positions pos [b, S]: Llama's halves over
    the whole head, or ChatGLM2's interleaved (even, odd) pairs over the
    first rope_fraction of it, the rest passed through."""
    hd = x.shape[-1]
    rot = int(hd * dims["rope_fraction"])
    inv = dims["rope_theta"] ** (-torch.arange(0, rot, 2, dtype=torch.float64,
                                               device=x.device) / rot)
    ang = (pos.double()[..., None] * inv).float()[:, :, None, :]        # [b, S, 1, rot/2]
    c, s = torch.cos(ang), torch.sin(ang)
    if dims["rope_interleaved"]:
        x0, x1, rest = x[..., 0:rot:2], x[..., 1:rot:2], x[..., rot:]
        out = torch.stack([x0 * c - x1 * s, x1 * c + x0 * s], -1).flatten(-2)
        return torch.cat([out, rest], -1)
    x1, x2 = x[..., : rot // 2], x[..., rot // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)


def _attention(q, k, v, group):
    """Causal attention, f32; kv heads shared by `group` query heads."""
    S = q.shape[1]
    k = k.repeat_interleave(group, 2)
    v = v.repeat_interleave(group, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


def decoder_layer(x, pos, W, vec, dims):
    B, S, D = x.shape
    H, KH, hd = dims["heads"], dims["kv_heads"], dims["head_dim"]
    h = _rms(x, vec["attn_norm"], dims["eps"])
    q, k, v = h @ W["q_proj"], h @ W["k_proj"], h @ W["v_proj"]
    if dims["qkv_bias"]:
        q, k, v = q + vec["q_bias"], k + vec["k_bias"], v + vec["v_bias"]
    q = _rope(q.view(B, S, H, hd), pos, dims)
    k = _rope(k.view(B, S, KH, hd), pos, dims)
    o = torch.cat([_attention(q[i:i + ROW_BLOCK], k[i:i + ROW_BLOCK],
                              v.view(B, S, KH, hd)[i:i + ROW_BLOCK], H // KH)
                   for i in range(0, B, ROW_BLOCK)])
    x = x + o.reshape(B, S, H * hd) @ W["o_proj"]
    h = _rms(x, vec["mlp_norm"], dims["eps"])
    g = h @ W["gate_proj"]
    return x + (g * torch.sigmoid(g) * (h @ W["up_proj"])) @ W["down_proj"]


# ------------------------------------------------------------------ judge

def served_logit_readings(cell, seed: int, device, sampled: List[Dict]):
    """For each sampled query ({"sentence", "movie", "query_feats",
    "tokens" [windows, G], "valid" [windows, G]}: the program's served
    tokens of every live window), the reference's logits at every served
    position given the prompt and the tokens served before it. Returns
    {"gap": [n] f64, ref best minus the served token's logit, and
    "entropy": [n] f64, the reference's entropy there}, over the valid
    positions in order (query, window, step)."""
    f32_matmuls()
    dims, acfg, ev = cell["dims"], cell["adapter"], cell["traffic"]["eval"]
    D, V, G = dims["hidden"], dims["vocab"], ev["max_new_tokens"]
    nf = ev["num_frames"]
    with torch.no_grad():
        tree = _to_f32(Wt.adapter(acfg, D, seed, device))
        embed = Wt.embed(dims, seed, device)
        xs, lens, served = [], [], []
        for q in sampled:
            idx = torch.as_tensor(window_frames(len(q["movie"]), ev), device=device).long()
            nw = len(idx)
            movie = torch.as_tensor(q["movie"], device=device)
            text = torch.as_tensor(q["query_feats"], device=device)
            vids = torch.cat([adapter_forward(tree, acfg, movie[rows], text.expand(
                len(rows), *text.shape)) for rows in idx.split(ROW_BLOCK)])
            ids = grounding_prompt_ids(q["sentence"])
            cut = ids.index(VIDEO)
            before = embed[torch.as_tensor(ids[:cut], device=device)].float()
            after = embed[torch.as_tensor(ids[cut + 1:], device=device)].float()
            # a token outside the vocabulary is malformed_queries' to count
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
        for i in range(dims["layers"]):
            W = {n: int8_weight(m) for n, m in Wt.layer_matrices(dims, seed, i, device).items()}
            vec = {n: t.float() for n, t in Wt.layer_vectors(dims, seed, i, device).items()}
            x = torch.cat([decoder_layer(x[b:b + ROW_BLOCK], pos[b:b + ROW_BLOCK], W, vec, dims)
                           for b in range(0, x.shape[0], ROW_BLOCK)])
            del W
        h = _rms(x, Wt.final_norm(dims, seed, device).float(), dims["eps"])
        head = int8_weight(Wt.lm_head(dims, seed, device))
        lens_t = torch.as_tensor(lens, device=device)
        at = (lens_t[:, None] - 1 + torch.arange(G, device=device)[None])    # [rows, G]
        hs = h[torch.arange(h.shape[0], device=device)[:, None], at]          # [rows, G, D]
        gaps, ents = [], []
        r0 = 0
        for toks, valid in served:
            for r in range(toks.shape[0]):
                logits = (hs[r0 + r] @ head).double()                        # [G, V]
                best = logits.max(-1).values
                gap = best - logits.gather(1, toks[r][:, None])[:, 0]
                p = torch.softmax(logits, -1)
                ent = -(p * torch.log(p + 1e-10)).sum(-1)
                keep = torch.as_tensor(valid[r], device=device)
                gaps.append(gap[keep].cpu().numpy())
                ents.append(ent[keep].cpu().numpy())
            r0 += toks.shape[0]
    return {"gap": np.concatenate(gaps), "entropy": np.concatenate(ents)}


def _to_f32(tree):
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_f32(v) for v in tree]
    return tree.float()
