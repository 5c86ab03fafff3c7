"""Batch decoding with inline confidence capture.

Counterpart of revisionllm_tpu/models/generation.py::generate: prefill once,
then a greedy decode loop that computes each step's softmax entropy and the
chosen token's log-probability in f32, and masks rows after their eos. The
`lax.scan` becomes a Python loop that only enqueues device work (no host
sync inside the loop). `generate_stream` yields one greedy token a step for
interactive use (the streaming chat), through eager split steps.

`generate` picks its decode route once (`_decode_route`):

- "serve": a tree packed by ops.decode_serve.pack_serving_weights, under
  KV8, unless REVISIONLLM_SERVE=0 (or set_serve(False)). The prefill writes
  the unified int8 KV slab (a shared-prefix prefill's split cache is
  packed into it); each step is one ops.decode_serve launch (row 10), then
  the final norm and the lm_head (JAX's generation.py:131-219).
- "mega": REVISIONLLM_MEGAKERNEL=1 (or set_megakernel) with an int8 tree
  the kernel covers, under KV8: each step is one ops.decode_step launch
  (row 9), then the final norm and the lm_head (JAX's :165-172).
- "graphs": any other call on the card in one process (no mesh that
  splits the weights) for more than one token: llama.decode_step_split
  replayed as CUDA graphs (`DecodeGraphs`), the prefill writing the
  chunk's prompt cache into the graphs' static buffers.
- "split": the rest (the CPU, the weight-splitting meshes): eager
  llama.decode_step_split steps.

A P-tuning prefix (`prefix_kv`, ChatGLM2's) is attended through the prefill
and every step; it takes neither row 9 nor row 10, as in JAX. DeepSeek-V2
(`cfg.latent_attention`, a bf16 latent cache {"latent"} under either KV8
setting) raises for both. Rows 9 and 10 hold whole layers in one launch,
so they raise under tensor or fsdp sharding, whose collectives cannot run
inside a launch; a mesh that splits only the batch keeps the tree whole.

`generate(mesh=)` runs a rank's shards of a sharded model (models/llama.py)
on the rows it is given; parallel/serve.py splits a batch over the ranks
and gathers it back.

`generate` is the span `model.generate` (utils/spans.py), with
`model.prefill` and one `model.decode_step` a forward step beneath it,
each on the host's clock and the device's. A step's span has the attribute
`replayed`: 1 for a graph replay, 0 for a step run eagerly (or captured).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from contextlib import nullcontext
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils.weak import WeakTensorKeyDictionary

from revisionllm_tpu_torch.config import LlamaConfig
from revisionllm_tpu_torch.models import llama
from revisionllm_tpu_torch.ops import decode_serve as DSV
from revisionllm_tpu_torch.ops import decode_step as DS
from revisionllm_tpu_torch.ops import quant
from revisionllm_tpu_torch.ops.norms import rms_norm
from revisionllm_tpu_torch.ops.rope import rope_angles
from revisionllm_tpu_torch.parallel.sharding import local_config
from revisionllm_tpu_torch.utils import spans

_KV8: Optional[bool] = None


def set_kv8(enabled: Optional[bool]) -> None:
    """Override the int8 prompt-KV switch (None = back to the environment and
    the device default)."""
    global _KV8
    _KV8 = enabled


def _kv8_enabled(device: torch.device) -> bool:
    """Int8 prompt-KV cache: set_kv8, else REVISIONLLM_KV8=0/1, else ON for
    CUDA tensors (serving numerics) and OFF on the CPU (exact parity), as
    JAX defaults it ON for the TPU only."""
    if _KV8 is not None:
        return _KV8
    env = os.environ.get("REVISIONLLM_KV8")
    if env is not None:
        return env == "1"
    return device.type == "cuda"


_MEGAKERNEL: Optional[bool] = None


def set_megakernel(enabled: Optional[bool]) -> None:
    """Override the megakernel switch (None = back to the environment)."""
    global _MEGAKERNEL
    _MEGAKERNEL = enabled


def _megakernel_enabled() -> bool:
    """The fused whole-step decode (ops/decode_step.py): set_megakernel,
    else REVISIONLLM_MEGAKERNEL=1; off by default, as in JAX. It also needs
    the int8 tree and KV8 (`generate` checks)."""
    if _MEGAKERNEL is not None:
        return _MEGAKERNEL
    return os.environ.get("REVISIONLLM_MEGAKERNEL", "0") == "1"


_SERVE: Optional[bool] = None


def set_serve(enabled: Optional[bool]) -> None:
    """Override the serving-layout switch (None = back to the environment)."""
    global _SERVE
    _SERVE = enabled


def _serve_enabled() -> Optional[bool]:
    """The serving-layout decode (ops/decode_serve.py): set_serve, else
    REVISIONLLM_SERVE=0/1, else None, which follows the weight layout: a
    packed tree decodes through it, a standard tree cannot (JAX's
    generation.py:85-98). It also needs KV8 (`generate` checks)."""
    if _SERVE is not None:
        return _SERVE
    env = os.environ.get("REVISIONLLM_SERVE")
    return None if env is None else env == "1"


def decode_step_serve(cfg: LlamaConfig, params: Dict[str, Any], slab: Dict[str, torch.Tensor],
                      s0: int, prompt_lens: torch.Tensor, step: int,
                      token_embeds: torch.Tensor) -> torch.Tensor:
    """One serving-layout decode step (JAX's generate, generation.py:
    207-228): the rope angles at prompt_lens + step, one ops.decode_serve
    call over the packed layers and the slab (which gets this step's k/v at
    s0 + step), the final norm and the lm_head. token_embeds [B, 1, D];
    returns logits [B, V] f32."""
    cos, sin = rope_angles((prompt_lens + step)[:, None], cfg.head_dim, cfg.rope_theta)
    hidden, _ = DSV.decode_step_serve(params["layers"], slab, prompt_lens, step,
                                      token_embeds[:, 0], cos[:, 0], sin[:, 0], s0,
                                      eps=cfg.rms_norm_eps)
    h = rms_norm(hidden[:, None, :], params["final_norm"], cfg.rms_norm_eps)
    return llama.logits_from_hidden(params, h[:, 0])


def decode_step_mega(cfg: LlamaConfig, params: Dict[str, Any], pkv: Dict[str, torch.Tensor],
                     prompt_lens: torch.Tensor, gen_cache: torch.Tensor, step: int,
                     token_embeds: torch.Tensor) -> torch.Tensor:
    """One megakernel decode step (JAX's generate, generation.py:207-228):
    the rope angles at prompt_lens + step, one ops.decode_step call over
    the packed prompt cache (gen_cache [L, 2, B, KH, Gp, hd] gets this
    step's k/v), the final norm and the lm_head. token_embeds [B, 1, D];
    returns logits [B, V] f32."""
    cos, sin = rope_angles((prompt_lens + step)[:, None], cfg.head_dim, cfg.rope_theta)
    hidden, _ = DS.decode_step_fused(params, pkv, gen_cache, prompt_lens, step,
                                     token_embeds[:, 0], cos[:, 0], sin[:, 0],
                                     eps=cfg.rms_norm_eps)
    h = rms_norm(hidden[:, None, :], params["final_norm"], cfg.rms_norm_eps)
    return llama.logits_from_hidden(params, h[:, 0])


def _decode_route(cfg: LlamaConfig, params: Dict[str, Any], embeds: torch.Tensor, G: int,
                  kv_quant: bool, mesh, prefix_kv, shared_prefix_len: int) -> str:
    """The decode route of one `generate` call, chosen once (module
    docstring): "serve", "mega", "graphs" or "split". Raises for the
    combinations that have none: a serving-packed tree or the megakernel
    under a mesh that splits the weights, a P-tuning prefix with a
    shared-prefix prefill of several rows, DeepSeek-V2 with row 9 or 10."""
    split = llama.model_mesh(mesh) is not None
    lq = params["layers"].get("q_proj")
    packed = isinstance(lq, dict) and "q8c" in lq
    if split and packed:
        raise ValueError("a serving-packed tree (row 10) decodes whole layers in one launch; "
                         "under tensor or fsdp sharding a collective cannot run inside it: "
                         "use a data-only mesh or the standard tree")
    if prefix_kv is not None and shared_prefix_len > 1 and embeds.shape[0] > 1:
        raise ValueError("P-tuning prefix + shared-prefix prefill unsupported")
    if cfg.latent_attention and (_megakernel_enabled() or _serve_enabled()):
        raise ValueError("DeepSeek-V2 (MLA and DeepSeekMoE) does not run with "
                         "REVISIONLLM_MEGAKERNEL=1 (row 9) or REVISIONLLM_SERVE=1 (row 10)")
    if (packed and prefix_kv is None and _serve_enabled() is not False and kv_quant
            and DSV.supports_serve(cfg, params)):
        return "serve"
    if (prefix_kv is None and _megakernel_enabled() and kv_quant
            and DS.supports_megakernel(cfg, params)):
        if split:
            raise ValueError("REVISIONLLM_MEGAKERNEL=1 (row 9) decodes whole layers in one "
                             "launch; under tensor or fsdp sharding a collective cannot run "
                             "inside it: unset it or use a data-only mesh")
        return "mega"
    return "graphs" if embeds.is_cuda and not split and G > 1 else "split"


def generate(
    cfg: LlamaConfig,
    params: Dict[str, Any],
    embeds: torch.Tensor,
    positions: torch.Tensor,
    prompt_lens: torch.Tensor,
    *,
    eos_id: int,
    max_new_tokens: int,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    shared_prefix_len: int = 0,
    prefix_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    mesh=None,
) -> Dict[str, torch.Tensor]:
    """Decode `max_new_tokens` for a right-padded batch of spliced prompts.

    embeds [B, T, D], positions [B, T], prompt_lens [B]. Returns tokens,
    entropy, logprob and valid, each [B, G]. When every row shares its first
    `shared_prefix_len` embeddings (the engine's window batches do), the
    prefill runs that prefix once (llama.prefill_shared_prefix).

    prefix_kv: a P-tuning prefix (pk, pv) [L, 1, P, KH, hd]
    (models.prefix), attended through the prefill and the decode, held at
    the cache's positions [0, P): the steps mask with prompt_lens + P and
    keep the rope positions on prompt_lens. It cannot be combined with a
    shared-prefix prefill of more than one row (ValueError), as in JAX.

    Greedy (temperature 0) matches JAX token for token. temperature > 0
    samples from softmax(logits / temperature) with `generator`; it cannot
    replay JAX's PRNG, so it agrees with JAX by distribution only.

    JAX's scan also runs a decode step after the last token and discards its
    logits; this loop skips that step, which changes no output.

    mesh: `params` are this rank's shards (parallel/sharding.py) and the
    model's collectives run over it (module docstring)."""
    with spans.span("model.generate", device=embeds.device):
        B, T = embeds.shape[:2]
        G = max_new_tokens
        prompt_lens = prompt_lens.to(torch.int32)
        kv_quant = _kv8_enabled(embeds.device)
        route = _decode_route(cfg, params, embeds, G, kv_quant, mesh, prefix_kv,
                              shared_prefix_len)
        P = 0 if prefix_kv is None else int(prefix_kv[0].shape[2])
        mask_lens = prompt_lens + P if P else None
        kv_out = None
        if route == "graphs":  # the prefill writes the cache into the set's buffers
            graphs = _decode_graphs(cfg, params, B, T + P, kv_quant, P > 0, G, embeds.dtype,
                                    embeds.device)
            kv_out = graphs.prompt
        with spans.span("model.prefill", device=embeds.device):
            if shared_prefix_len > 1 and B > 1:
                logits, prompt_kv = llama.prefill_shared_prefix(
                    cfg, params, embeds, positions, shared_prefix_len, kv_lens=prompt_lens,
                    kv_quant=kv_quant, mesh=mesh, kv_out=kv_out,
                )
            else:
                logits, prompt_kv = llama.prefill_kv(
                    cfg, params, embeds, positions, kv_lens=prompt_lens, kv_quant=kv_quant,
                    kv_slab_slots=G if route == "serve" else None, prefix_kv=prefix_kv,
                    mesh=mesh, kv_out=kv_out,
                )
        if route == "graphs":
            graphs.load(prompt_lens, mask_lens)
        elif route == "serve":
            # the shared-prefix prefill writes the split cache: packed here
            slab, s0 = (prompt_kv, T) if "kv" in prompt_kv else DSV.pack_unified_kv(prompt_kv, G)
        elif route == "mega":
            pkv = DS.pack_prompt_kv(prompt_kv)
            gen_cache = DS.init_gen_cache(cfg.num_layers, B, cfg.num_kv_heads, cfg.head_dim, G,
                                          embeds.dtype, embeds.device)
        else:
            gen_cache = llama.init_gen_cache(local_config(cfg, llama.model_mesh(mesh)), B, G,
                                             embeds.dtype, embeds.device)
        if route != "split":
            prompt_kv = None  # only the eager split steps read the prefill's cache again

        def decode_one(g, tok_embed):
            if route == "graphs":
                return graphs.step(cfg, params, g, tok_embed)
            spans.note(replayed=0)
            if route == "serve":
                return decode_step_serve(cfg, params, slab, s0, prompt_lens, g, tok_embed)
            if route == "mega":
                return decode_step_mega(cfg, params, pkv, prompt_lens, gen_cache, g, tok_embed)
            return llama.decode_step_split(
                cfg, params, prompt_kv, prompt_lens, gen_cache, g, tok_embed, mask_lens,
                mesh=mesh)[0]

        done = torch.zeros(B, dtype=torch.bool, device=embeds.device)
        tokens, entropies, logprobs, valids = [], [], [], []
        for g in range(G):
            logits32 = logits.float()
            probs = torch.softmax(logits32, dim=-1)
            entropy = -(probs * torch.log(probs + 1e-10)).sum(dim=-1)
            if temperature > 0.0:
                token = torch.multinomial(
                    torch.softmax(logits32 / temperature, dim=-1), 1, generator=generator
                )[:, 0]
            else:
                token = torch.argmax(logits32, dim=-1)
            logprob = torch.log(probs.gather(-1, token[:, None])[:, 0] + 1e-10)
            valid = ~done
            token_out = torch.where(valid, token, torch.full_like(token, eos_id))
            if g + 1 < G:
                with spans.span("model.decode_step", device=embeds.device, step=g):
                    tok_embed = llama.embed_tokens(params, token_out[:, None], mesh).to(
                        embeds.dtype)
                    logits = decode_one(g, tok_embed)
            done = done | (token_out == eos_id)
            tokens.append(token_out)
            entropies.append(entropy)
            logprobs.append(logprob)
            valids.append(valid)
        return {
            "tokens": torch.stack(tokens, dim=1),
            "entropy": torch.stack(entropies, dim=1),
            "logprob": torch.stack(logprobs, dim=1),
            "valid": torch.stack(valids, dim=1),
        }


DECODE_GRAPH_POSITIONS = 64  # prompt caches pad to a multiple: one graph set serves many lengths
DECODE_GRAPH_SETS = 2        # graph sets a tree keeps (the least recently used goes first)

# a weight tree's decode graph sets, keyed by its embedding: an OrderedDict
# {shape key: DecodeGraphs}, the one its last generate used at the end
_DECODE_GRAPHS = WeakTensorKeyDictionary()


def _graph_set(params, key, make):
    """The set of this tree at `key` (made by `make()` when it has none),
    now the tree's most recent; at most DECODE_GRAPH_SETS sets a tree, the
    least recently used dropped before a new one is made."""
    sets = _DECODE_GRAPHS.get(params["embed"])
    if sets is None:
        sets = _DECODE_GRAPHS[params["embed"]] = OrderedDict()
    graphs = sets.pop(key, None)
    if graphs is None:
        while len(sets) >= DECODE_GRAPH_SETS:
            sets.popitem(last=False)
        graphs = make()
    sets[key] = graphs
    return graphs


def _decode_graphs(cfg, params, batch, length, kv_quant, masked, slots, dtype, device):
    """The decode graphs of this tree and shape. The key holds everything a
    capture fixes: the configuration, batch, prompt length padded to
    DECODE_GRAPH_POSITIONS, slots, the cache's layout, whether the mask
    differs from the lengths, the matmul switches the step reads (row 8,
    W8A8, the exact route) and the identity of the tree's entries besides
    the embedding (the layers, the head), which the set keeps alive while
    its graphs read them."""
    S = -(-length // DECODE_GRAPH_POSITIONS) * DECODE_GRAPH_POSITIONS
    layout = llama.prompt_cache_layout(cfg, batch, S, kv_quant, dtype)
    switches = (llama._fused_mlp_enabled(), quant._w8a8_enabled(device), quant._EXACT_TRACE)
    weights = tuple((k, id(v)) for k, v in sorted(params.items()) if k != "embed")
    key = (cfg, batch, slots, dtype, tuple(sorted(layout.items())), masked, switches, weights)
    return _graph_set(params, key, lambda: DecodeGraphs(cfg, params, batch, layout, slots, dtype,
                                                         masked, device))


def mla_decode_counts(params) -> List[List[torch.Tensor]]:
    """The rows routed to each expert [E] int64 in every MoE layer of every
    decode step of the last `generate` on this tree's decode graphs, by step
    and then layer ([] for a tree that has none). Replayed steps' are the
    graphs' own buffers, rewritten by the next replay: copy what is kept."""
    sets = _DECODE_GRAPHS.get(params["embed"])
    return [] if not sets else list(next(reversed(sets.values())).counts)


class DecodeGraphs:
    """The split decode steps on the card as CUDA graphs, for one (batch,
    padded prompt length, slots) shape of one tree. Eagerly, the host that
    enqueues a step's ~1 000 (dense) or ~2 000 (MLA) small launches paces
    it; replayed, a dense step is one graph launch, and DeepSeek-V2's a
    graph a piece of `llama.mla_decode_pieces` (the prologue, a layer's
    attention, its MLP, the head), each replay under the span the eager
    piece has, so spans and the profiler see the kernels the timed steps
    run.

    The graphs' inputs are static buffers: `prompt`, the prompt cache in
    llama.prompt_cache_layout over S positions, which each chunk's prefill
    writes as its `kv_out` (past each row's mask length it is masked as
    the eager step masks it, so what a longer earlier chunk left there is
    never read); the generated cache; the lengths and, with a P-tuning
    prefix, the mask lengths, which `load` copies; the token's embedding.
    A step index's first call runs its pieces eagerly (the result, and the
    warm-up) and then captures them; later calls replay, and note
    `replayed` on the open span. A capture that fails raises. The wrappers
    count their launches (utils/kernels.LAUNCHES) as the host makes them:
    at the eager run and at capture, not at replay; the profiler sees the
    kernels a replay runs."""

    def __init__(self, cfg, params, batch, layout, slots, dtype, masked, device):
        self.prompt = {name: torch.zeros(shape, dtype=dt, device=device)
                       for name, (shape, dt) in layout.items()}
        self.gen = llama.init_gen_cache(cfg, batch, slots, dtype, device)
        self.lens = torch.zeros(batch, dtype=torch.int32, device=device)
        self.mask = torch.zeros_like(self.lens) if masked else self.lens
        self.tok = torch.zeros((batch, 1, cfg.hidden_size), dtype=dtype, device=device)
        self.weights = {k: v for k, v in params.items() if k != "embed"}
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.graphs: Dict[int, tuple] = {}
        self.counts: List[List[torch.Tensor]] = []

    def load(self, prompt_lens, mask_lens=None):
        """A chunk's lengths (and mask lengths) into the inputs; its prefill
        wrote the prompt cache into `self.prompt` (kv_out)."""
        self.lens.copy_(prompt_lens)
        if mask_lens is not None:
            self.mask.copy_(mask_lens)
        self.counts = []

    def _pieces(self, cfg, params, g):
        if cfg.latent_attention:
            return llama.mla_decode_pieces(cfg, params, self.prompt, self.lens, self.gen, g,
                                           self.tok, self.mask)
        st: Dict[str, Any] = {}

        def step():
            st["logits"] = llama.decode_step_split(cfg, params, self.prompt, self.lens, self.gen,
                                                   g, self.tok, self.mask)[0]

        return [(None, None, step)], st

    def step(self, cfg, params, g, tok_embed):
        self.tok.copy_(tok_embed)
        dev = self.tok.device
        if g not in self.graphs:
            pieces, st = self._pieces(cfg, params, g)
            counters = [llama.run_mla_piece(*piece, dev) for piece in pieces]
            self.graphs[g] = self._capture(cfg, params, g)
            self.counts.append([c[2] for c in counters if c is not None])
            spans.note(replayed=0)
            return st["logits"]
        pieces, logits = self.graphs[g]
        for name, layer, graph, counters in pieces:
            with spans.span(name, device=dev, layer=layer) if name else nullcontext():
                graph.replay()
                llama.note_moe(counters)
        self.counts.append([c[2] for *_, c in pieces if c is not None])
        spans.note(replayed=1)
        return logits

    def _capture(self, cfg, params, g):
        """Step g's pieces captured in order, a graph each, on a side
        stream into the set's one memory pool (not torch.cuda.graph, whose
        entry collects garbage and empties the cache, a cost paid here once
        a piece): ([(name, layer, graph, the MoE counters in its buffers)],
        the logits' buffer)."""
        pieces, st = self._pieces(cfg, params, g)
        out = []
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            for name, layer, fn in pieces:
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(pool=self.pool)
                counters = fn()
                graph.capture_end()
                out.append((name, layer, graph, counters))
        torch.cuda.current_stream().wait_stream(self.stream)
        return out, st["logits"]


def entropy_stats_from_steps(entropy: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[B, G] per-step entropies + validity -> [B, 4] (max, min, mean, std)."""
    m = valid.float()
    n = m.sum(dim=1).clamp(min=1.0)
    neg_inf = torch.tensor(-3.4e38, dtype=torch.float32, device=entropy.device)
    e_max = torch.where(valid, entropy, neg_inf).amax(dim=1)
    e_min = torch.where(valid, entropy, -neg_inf).amin(dim=1)
    e_mean = (entropy * m).sum(dim=1) / n
    var = (m * (entropy - e_mean[:, None]) ** 2).sum(dim=1) / (n - 1.0).clamp(min=1.0)
    e_std = torch.where(n > 1, torch.sqrt(var), torch.zeros_like(var))
    return torch.stack([e_max, e_min, e_mean, e_std], dim=1)


def generate_stream(
    cfg: LlamaConfig,
    params: Dict[str, Any],
    embeds: torch.Tensor,
    positions: torch.Tensor,
    prompt_lens: torch.Tensor,
    *,
    eos_id: int,
    max_new_tokens: int,
) -> Iterator[int]:
    """Greedy decoding as a generator of row 0's token ids, one host
    round-trip a token (JAX's generation.py:280-322; the role of the
    reference demo's TextStreamer). The prefill runs once (prefill_kv, int8
    prompt KV under the same switch as `generate`); every step is one
    llama.decode_step_split over a [L, B, G, KH, hd] generated-token cache.
    It stops at eos without running the step after it, and skips the step
    after the last token, whose logits JAX computes and drops."""
    B = embeds.shape[0]
    G = max_new_tokens
    prompt_lens = prompt_lens.to(torch.int32)
    logits, prompt_kv = llama.prefill_kv(
        cfg, params, embeds, positions, kv_lens=prompt_lens,
        kv_quant=_kv8_enabled(embeds.device),
    )
    gen_cache = llama.init_gen_cache(cfg, B, G, embeds.dtype, embeds.device)
    for g in range(G):
        token = int(torch.argmax(logits[0]))
        if token == eos_id:
            return
        yield token
        if g + 1 == G:
            return
        ids = torch.full((B, 1), token, dtype=torch.long, device=embeds.device)
        tok_embed = llama.embed_tokens(params, ids).to(embeds.dtype)
        logits = llama.decode_step_split(cfg, params, prompt_kv, prompt_lens, gen_cache, g,
                                         tok_embed)[0]
