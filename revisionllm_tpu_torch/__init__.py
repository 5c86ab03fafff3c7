"""PyTorch/CUDA port of revisionllm_tpu for NVIDIA Hopper (H100).

The JAX package `revisionllm_tpu` is the reference; this package mirrors its
module names so each counterpart is easy to find, and keeps its layouts at
public functions (matrices [in, out] stacked on a leading L axis, int8
weights as {"q8", "scale"}, caches [L, B, S, KH, hd]).

It imports torch and numpy and never jax or revisionllm_tpu. Every Pallas
kernel on the ported path is a CUDA C++ kernel under `csrc/`, built with
nvcc for sm_90a at first use (`utils/kernels.py`). Each kernel's wrapper
runs its plain PyTorch version only for CPU tensors; a CUDA tensor launches
the kernel or raises. Entry points run on CUDA unless the caller passes
device="cpu".
"""
