"""Shared helpers for the port's parity tests (tests/test_torch_*.py): one
seed, numpy inputs, both packages, tensors on the CPU."""

import jax
import numpy as np
import torch

from revisionllm_tpu_torch.models.weights import params_from_numpy

CPU = torch.device("cpu")


def to_torch(tree, dtype=None):
    """A JAX parameter tree -> the port's tree of CPU tensors."""
    return params_from_numpy(jax.tree.map(np.asarray, tree), CPU, dtype)


def np_of(t):
    """torch tensor or JAX array -> float64 numpy (for comparisons)."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy().astype(np.float64)
    return np.asarray(t, dtype=np.float64)


def tiny_cfgs(num_kv_heads=4, vocab_size=512):
    """The same tiny f32 Llama geometry in both packages' config classes."""
    from revisionllm_tpu.config import LlamaConfig as JCfg
    from revisionllm_tpu_torch.config import LlamaConfig as TCfg

    kw = {**JCfg.tiny(vocab_size).__dict__, "dtype": "float32", "num_kv_heads": num_kv_heads}
    return JCfg(**kw), TCfg(**kw)
