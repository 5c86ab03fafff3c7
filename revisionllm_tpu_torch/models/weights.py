"""Parameter trees from NumPy: the port's counterpart of
revisionllm_tpu/models/convert.py's hand-over to the device.

`params_from_numpy` turns a parameter tree given as nested dicts / lists of
NumPy arrays -- the JAX package's llama tree (including int8 {"q8",
"scale"}, int4 {"q4", "scale4"} and serving-packed {"q8c"} / {"q8r"}
leaves, and the ChatGLM2 q/k/v biases), its vision (ClipEncoder) tree
(with the chapters `text_proj`, the T2V layers' self-attention variants
and `alternate_ln`), the P-tuning prefix tree or a LoRA tree, e.g.
`jax.tree.map(np.asarray, params)` -- into the same tree of torch tensors
on `device`; `requires_grad=True` marks the
floating-point leaves of a tree to be trained (LoRA, vision). The HF
checkpoint loader (models/convert.py, eval/loader.py) hands its trees over
through it.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def _tensor(a: np.ndarray, device, dtype: Optional[torch.dtype], keep: bool) -> torch.Tensor:
    a = np.array(a)  # a writable copy (arrays from JAX are read-only)
    if a.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16 (what np.asarray gives for a JAX bf16 array)
        # has no torch.from_numpy mapping: move the bits and reinterpret
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point() and not keep:
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(
    tree: Any, device, dtype: Optional[torch.dtype] = None, _key: str = "",
    requires_grad: bool = False,
) -> Any:
    """Nested dicts / lists / tuples of arrays -> the same structure of
    tensors on `device`. `dtype`, when given, casts floating-point leaves,
    except the quantization scales ("scale" and "scale4" leaves), which stay
    f32, and so do the performer's random "features" (an f32 buffer in
    JAX's adapter tree whatever its dtype); int8 (q8, q8c, q8r) stays int8
    and packed int4 stays uint8. Python ints (a tree's geometry, e.g.
    CLIP's patch_size) stay ints."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype, k, requires_grad) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, dtype, _key, requires_grad) for v in tree)
    if isinstance(tree, int):
        return tree
    t = _tensor(tree, device, dtype, keep=_key in ("scale", "scale4", "features"))
    if requires_grad and t.is_floating_point():
        t.requires_grad_(True)
    return t
