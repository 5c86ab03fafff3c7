"""Parameter trees from NumPy: the port's counterpart of
revisionllm_tpu/models/convert.py's hand-over to the device.

`params_from_numpy` turns a parameter tree given as nested dicts / lists of
NumPy arrays -- the JAX package's llama tree (including {"q8", "scale"}
leaves) or its vision tree, e.g. `jax.tree.map(np.asarray, params)` -- into
the same tree of torch tensors on `device`. Loading HF checkpoints
(convert.py, eval/loader.py) waits until real weights are in the repository.
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


def params_from_numpy(tree: Any, device, dtype: Optional[torch.dtype] = None, _key: str = "") -> Any:
    """Nested dicts / lists / tuples of arrays -> the same structure of
    tensors on `device`. `dtype`, when given, casts floating-point leaves,
    except int8 scales ("scale" leaves), which stay f32; int8 stays int8."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, dtype, _key) for v in tree)
    return _tensor(tree, device, dtype, keep=_key == "scale")
