"""Single-call inference API, in PyTorch.

Counterpart of revisionllm_tpu/inference.py (the reference's
inference.py:28-75): build the v1 prompt around the user query (with
'<memory>' appended when a visual memory is given, and any earlier turns of
a chat), tokenize it with the sentinels spliced in, repeat one splice plan
across the window batch, decode with confidence capture and strip the stop
string. `inference_stream` yields the growing answer token by token.

Everything runs on the device the parameters are on.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from revisionllm_tpu_torch.config import AdapterConfig, LlamaConfig
from revisionllm_tpu_torch.conversation import CONV_VICUNA_V1
from revisionllm_tpu_torch.models import generation, llama, revisionllm
from revisionllm_tpu_torch.models.multimodal import build_splice_plan, stack_plans
from revisionllm_tpu_torch.tokenization import tokenizer_image_token


def _prompt_ids(tokenizer, query: str, history: Optional[List[Tuple[str, str]]]) -> List[int]:
    """The v1 prompt of the earlier (user, assistant) turns and `query`,
    tokenized with the sentinels spliced in."""
    conv = CONV_VICUNA_V1
    msgs: List[Tuple[str, Optional[str]]] = []
    for u, a in history or []:
        msgs.append((conv.roles[0], u))
        msgs.append((conv.roles[1], a))
    msgs.append((conv.roles[0], query))
    msgs.append((conv.roles[1], None))
    return tokenizer_image_token(conv.prompt(msgs), tokenizer)


def _device_inputs(plan_np, image, query_feats, query_valid, device, dtype):
    plan = {k: torch.as_tensor(v, device=device) for k, v in plan_np.items()}
    images = torch.as_tensor(np.asarray(image), device=device).to(dtype)
    qf = None if query_feats is None else \
        torch.as_tensor(np.asarray(query_feats), device=device).to(dtype)
    qv = None if query_valid is None else torch.as_tensor(np.asarray(query_valid), device=device)
    return plan, images, qf, qv


def _memory_tokens(adapter_cfg: AdapterConfig, params, vision_params, visual_memory,
                   prefix_memory_ids, B: int, device, dtype) -> torch.Tensor:
    """The <memory> block [B, P + M, hidden]: the memory clip [B, d] or
    [B, M, d] through the mlp projector, or through a ClipEncoder adapter
    in dense temporal mode (the reference calls the adapter module on the
    memory clip as on a window, vtimellm_arch.py:221-222), after the
    embeddings of `prefix_memory_ids` when given."""
    mem = np.asarray(visual_memory)
    if mem.ndim == 2:
        mem = mem[:, None]
    mem = torch.as_tensor(mem, dtype=torch.float32, device=device)
    if adapter_cfg.kind != "mlp":
        adapter_cfg = dataclasses.replace(adapter_cfg, hierarchy=False, feature_mode="temporal")
    tokens = revisionllm.encode_video(adapter_cfg, vision_params, mem.to(dtype))
    if prefix_memory_ids is not None:
        ids = torch.as_tensor(np.asarray(prefix_memory_ids), dtype=torch.long, device=device)
        prefix = llama.embed_tokens(params, ids)
        if prefix.dim() == 2:
            prefix = prefix[None]
        prefix = prefix.expand(B, prefix.shape[-2], prefix.shape[-1])
        tokens = torch.cat([prefix.to(tokens.dtype), tokens], dim=1)
    return tokens.to(dtype)


def inference(
    llama_cfg: LlamaConfig,
    adapter_cfg: AdapterConfig,
    params: Dict[str, Any],
    vision_params: Dict[str, Any],
    tokenizer,
    image: np.ndarray,
    query: str,
    query_feats: Optional[np.ndarray] = None,
    query_valid: Optional[np.ndarray] = None,
    visual_memory: Optional[np.ndarray] = None,
    prefix_memory_ids: Optional[np.ndarray] = None,
    *,
    eos_id: int = 2,
    max_new_tokens: int = 64,
    temperature: float = 0.0,
    return_list: bool = False,
    history: Optional[List[Tuple[str, str]]] = None,
) -> Tuple[Union[str, List[str]], Dict[str, Any]]:
    """image: [B, T, d] window batch (or [B, V, T, d] hierarchy). `history`
    holds the earlier (user, assistant) turns of a chat. Returns (answers,
    generate_grounding's output dict); answers is a string when B == 1 and
    not `return_list`."""
    if visual_memory is not None:
        query = query + "<memory>"
    ids = _prompt_ids(tokenizer, query, history)
    device = params["embed"].device
    dtype = llama.torch_dtype(llama_cfg.dtype)
    B, num_video = image.shape[0], image.shape[1]  # windows (hierarchy) or frames

    memory_tokens = None
    num_memory = 0
    if visual_memory is not None:
        memory_tokens = _memory_tokens(adapter_cfg, params, vision_params, visual_memory,
                                       prefix_memory_ids, B, device, dtype)
        num_memory = int(memory_tokens.shape[1])

    max_len = len(ids) - 1 + num_video + num_memory + max_new_tokens + 8
    plan_np = stack_plans([build_splice_plan(ids, num_video, max_len,
                                             num_memory_tokens=num_memory)] * B)
    plan, images, qf, qv = _device_inputs(plan_np, image, query_feats, query_valid, device,
                                          dtype)
    out = revisionllm.generate_grounding(
        llama_cfg, adapter_cfg, params, vision_params, plan, images, qf, qv,
        memory_tokens=memory_tokens, eos_id=eos_id, max_new_tokens=max_new_tokens,
        temperature=temperature,
    )

    stop = CONV_VICUNA_V1.stop_str
    answers: List[str] = []
    for row, v in zip(out["tokens"].cpu().numpy(), out["valid"].cpu().numpy()):
        keep = [int(t) for t, ok in zip(row, v) if ok and int(t) != eos_id]
        text = tokenizer.decode(keep, skip_special_tokens=True).strip()
        if text.endswith(stop):
            text = text[: -len(stop)].strip()
        answers.append(text)
    if len(answers) == 1 and not return_list:
        return answers[0], out
    return answers, out


def inference_stream(
    llama_cfg: LlamaConfig,
    adapter_cfg: AdapterConfig,
    params: Dict[str, Any],
    vision_params: Dict[str, Any],
    tokenizer,
    image: np.ndarray,
    query: str,
    query_feats: Optional[np.ndarray] = None,
    query_valid: Optional[np.ndarray] = None,
    *,
    eos_id: int = 2,
    max_new_tokens: int = 64,
    history: Optional[List[Tuple[str, str]]] = None,
) -> Iterator[str]:
    """Token-by-token `inference` for one row (B == 1): yields the decoded
    answer so far after each token (the reference demo's TextStreamer,
    demo_gradio.py:133-141); the last string is the whole answer."""
    ids = _prompt_ids(tokenizer, query, history)
    if image.shape[0] != 1:
        raise ValueError("streaming decode is single-row (the chat path)")
    device = params["embed"].device
    dtype = llama.torch_dtype(llama_cfg.dtype)
    num_video = image.shape[1]
    max_len = len(ids) - 1 + num_video + max_new_tokens + 8
    plan_np = stack_plans([build_splice_plan(ids, num_video, max_len)])
    plan, images, qf, qv = _device_inputs(plan_np, image, query_feats, query_valid, device,
                                          dtype)
    video_tokens = revisionllm.encode_video(adapter_cfg, vision_params, images, qf, qv)
    embeds, positions, lengths = revisionllm.assemble_inputs(params, plan, video_tokens,
                                                             dtype=dtype)
    stop = CONV_VICUNA_V1.stop_str
    toks: List[int] = []
    for token in generation.generate_stream(llama_cfg, params, embeds, positions, lengths,
                                            eos_id=eos_id, max_new_tokens=max_new_tokens):
        toks.append(token)
        text = tokenizer.decode(toks, skip_special_tokens=True).strip()
        if text.endswith(stop):
            yield text[: -len(stop)].strip()
            return
        yield text
