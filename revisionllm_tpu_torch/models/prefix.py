"""P-tuning v2 prefix encoder (the ChatGLM2 surface), in PyTorch: the
counterpart of revisionllm_tpu/models/prefix.py.

Reference model/chatglm/modeling_chatglm.py PrefixEncoder (:61-89) and
ChatGLMModel.get_prompt (:770-783):

- a learned table of `pre_seq_len` entries, each one (k, v) pair per layer
  per kv head, optionally re-encoded by a two-layer tanh MLP
  (`prefix_projection`, :71-79);
- the prefix k/v are prepended to every sequence's attention keys and
  values without rotary (they enter as past_key_values, :808-812), every
  query position sees the whole prefix (:813-814), and real-token positions
  are not shifted (:1061-1062);
- dropout 0.1 on the prefix while training (:765).

The prefix is computed once per forward as [L, 1, P, KH, hd] tensors,
broadcast over the rows inside the attention (models/llama.py).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from revisionllm_tpu_torch.config import LlamaConfig
from revisionllm_tpu_torch.utils.device import resolve_device


def init_prefix_params(
    cfg: LlamaConfig,
    pre_seq_len: int,
    gen: torch.Generator,
    prefix_projection: bool = False,
    dtype=torch.float32,
    device=None,
) -> Dict[str, Any]:
    """Fresh P-tuning parameters from `gen` (PrefixEncoder.__init__), on
    `device` (default CUDA): the table "embed" [P, kv_size], kv_size =
    num_layers * 2 * num_kv_heads * head_dim (modeling_chatglm.py:73); with
    projection a 2-layer MLP "proj" kv_size -> hidden -> kv_size
    (:75-79)."""
    device = resolve_device(device)
    kv_size = cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim

    def normal(shape):
        return (0.02 * torch.randn(shape, generator=gen, device=device)).to(dtype)

    out: Dict[str, Any] = {"embed": normal((pre_seq_len, kv_size))}
    if prefix_projection:
        D = cfg.hidden_size
        out["proj"] = {
            "w1": normal((kv_size, D)),
            "b1": torch.zeros((D,), dtype=dtype, device=device),
            "w2": normal((D, kv_size)),
            "b2": torch.zeros((kv_size,), dtype=dtype, device=device),
        }
    return out


def prefix_kv(
    cfg: LlamaConfig,
    pparams: Dict[str, Any],
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefix parameters -> (pk, pv), each [L, 1, P, KH, hd], contiguous.

    get_prompt's view/permute/split (modeling_chatglm.py:773-783):
    [P, L*2*KH*hd] -> [P, L, 2, KH, hd] -> [L, 2, P, KH, hd]. Dropout
    (the reference's 0.1) applies to the prefix values when a `generator`
    is given (training; its keep masks agree with JAX's in distribution
    only); inference passes none."""
    x = pparams["embed"]
    if "proj" in pparams:
        p = pparams["proj"]
        x = torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    P = x.shape[0]
    L, KH, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    x = x.reshape(P, L, 2, KH, hd)
    if dropout_rate > 0.0 and generator is not None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - dropout_rate
        x = torch.where(keep, x / (1.0 - dropout_rate), torch.zeros_like(x))
    x = x.permute(1, 2, 0, 3, 4)
    return x[:, 0, None].contiguous(), x[:, 1, None].contiguous()
