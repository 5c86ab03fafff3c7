"""Build, load and count the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface. It is compiled by nvcc for
sm_90a into its own shared library, at first use, into `build/kernels/` at
the root of the checkout (listed in .gitignore), and loaded with ctypes.
The library's file name carries a hash of its source, of the shared headers
(`csrc/*.cuh`) and of the flags, so an edited source or header is rebuilt and
a stale library is never loaded. `build()` starts one
nvcc per source, all together, and waits for them.

Every wrapper adds one to its kernel's count in `LAUNCHES` where it launches
the kernel, and nowhere else, so a run can show that its path went through
the kernels (one source may hold several kernels, each with its own count).
Nothing here is touched when a module is imported: the CPU tests import every
module on a machine without nvcc.

A kernel without a backward would cut a grad-requiring input out of the
autograd graph (its output is filled through ctypes), so every such wrapper
calls `forbid_grad` on its CUDA branch and raises instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = (
    "int8_matmul", "flash_attention", "decode_attention", "flash_attention_vjp",
    "int4_matmul", "w8a8_mlp_fused", "decode_step", "decode_serve", "w8a8_gemm",
)
# launch counters, one per kernel: flash_attention.cu holds K2, the LSE
# forward (row 4's flash_fwd_lse and row 5's flash_attention_lse, counted
# by their wrappers) and row 6 (flash_attention_prefixed),
# flash_attention_vjp.cu row 4's dq and dk/dv; int4_matmul.cu row 7,
# w8a8_mlp_fused.cu row 8, decode_step.cu row 9 (decode_step_fused),
# decode_serve.cu row 10 (decode_step_serve); w8a8_gemm.cu the W8A8
# prefill's row quantizer, weight transpose and GEMM, and the grouped expert
# GEMM (moe_w8a8); int8_matmul.cu also the grouped W8A16 (moe_w8a16)
COUNTERS = (
    "int8_matmul", "flash_attention", "decode_attention",
    "flash_fwd_lse", "flash_dq", "flash_dkv",
    "flash_attention_lse", "flash_attention_prefixed",
    "int4_matmul", "w8a8_mlp_fused", "decode_step_fused", "decode_step_serve",
    "quantize_rows", "w8a8_transpose", "w8a8_gemm", "moe_w8a8", "moe_w8a16",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: Dict[str, int] = {name: 0 for name in COUNTERS}
_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[tuple, ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{tag}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every missing library of `names` in parallel; returns the
    seconds each build took (0.0 for one already built). The ptxas report
    (registers, shared memory, spills) lands beside each library as .log."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds: Dict[str, float] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        procs[name] = (
            subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT,
            ),
            tmp, out, log, time.time(),
        )
    failed = []
    for name, (proc, tmp, out, log, t0) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.time() - t0
        if rc != 0:
            failed.append(f"{name}: nvcc exited {rc}\n{out.with_suffix('.log').read_text()}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C function `symbol` of kernel `name`, typed once (returns an int
    CUDA error code)."""
    fn = _FNS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _FNS[(name, symbol)] = fn
    return fn


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream of t's device."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def forbid_grad(name: str, *tensors) -> None:
    """Raise when autograd is recording and any tensor requires grad: kernel
    `name` has no backward, so its output would silently drop the graph."""
    if torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            f"{name}: this kernel has no backward and an input requires grad; "
            "take a differentiable route (ops.quant.set_exact_trace, "
            "ops.flash_attention.trainable_attention) or run under torch.no_grad()"
        )
