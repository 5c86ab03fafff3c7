"""Copies of one CUDA source with constants overridden or parts cut out,
built side by side: what the kernel probes (torch_int4_probe.py,
torch_int8_kernel.py, torch_fused_mlp_kernel.py) share.

A SPEC is a comma-separated list of items. CONST=VALUE overrides the
source's `constexpr int CONST = ...;`; any other item names an edit, a list
of (old text, new text) replacements whose old text must still be in the
source. Nothing here needs a GPU; `build` needs nvcc.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path


def variant_source(src: str, spec: str, edits: dict, label: str) -> str:
    """src with spec's overrides and edits applied; label names the source
    in the errors."""
    for item in filter(None, spec.split(",")):
        if "=" in item:
            name, value = item.split("=", 1)
            src, n = re.subn(rf"constexpr int {name} = [^;]+;",
                             f"constexpr int {name} = {value};", src)
            if n != 1:
                raise SystemExit(f"no constexpr int {name} in {label}")
        else:
            if item not in edits:
                raise SystemExit(f"unknown edit {item}: one of {', '.join(edits)}")
            for old, new in edits[item]:
                if old not in src:
                    raise SystemExit(f"edit {item}: its line is not in {label} any more")
                src = src.replace(old, new)
    return src


def has_cut(spec: str, cuts: dict) -> bool:
    """Whether spec names one of the cuts (edits that break the results)."""
    return any(item in cuts for item in spec.split(","))


def build(sources: dict, out: Path) -> dict:
    """{name: ctypes.CDLL} of each variant of `sources`, {name: (source
    text, spec, include directory)}, written to and built in `out` by one
    nvcc each, all started together. Prints each variant's ptxas registers
    and spill stores and its wgmma, setmaxnreg and performance warnings."""
    from revisionllm_tpu_torch.utils import kernels

    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, _, include) in sources.items():
        cu = out / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(include), "-o",
             str(out / f"{name}.so"), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"variant {name}: nvcc failed\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"# {name} ({sources[name][1] or 'as is'}): registers {regs}, spill stores {spills}",
              flush=True)
        for line in log.splitlines():
            if "wgmma" in line or "setmaxnreg" in line or "Performance" in line:
                print(f"#   {line.strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs
