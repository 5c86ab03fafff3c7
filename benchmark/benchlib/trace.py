"""Reading a torch.profiler run: the device's operations with their
intervals, kernel time by group, the union of busy intervals, the idle
gaps and what the host was doing in them.

KERNEL_GROUPS, OTHER and group_kernels are frozen copies of
chip_smoke.py:327-364 (read_profile keeps kernel_events' filter, :315-325),
so a change to the program cannot move them. One difference: busy time
here is the union of the device's intervals on the timeline, not a sum of
kernel times."""

from __future__ import annotations

import bisect
import re
from typing import Dict, List, Optional, Tuple

# device kernels by what launched them: the hand-written kernels by their
# __global__ names, then the int8 GEMM of the W8A8 prefill (torch._int_mm),
# then the other library GEMMs (the adapter's bf16 products)
KERNEL_GROUPS = (
    ("K1 int8_matmul (q8_matmul, one launch)", r"q8_matmul_kernel"),
    ("K2 flash_attention", r"flash_fwd_kernel"),
    ("K3 decode_attention", r"decode_attn_kernel"),
    ("row 4 flash_fwd_lse", r"flash_fwd_lse_kernel"),
    ("row 4 flash_dq", r"flash_dq_kernel"),
    ("row 4 flash_dkv", r"flash_dkv_kernel"),
    ("row 7 int4_matmul (q4_matmul, one launch)", r"q4_matmul_kernel"),
    ("row 8 w8a8_mlp_fused (transpose + GEMM + requantize)",
     r"mlp_transpose_kernel|mlp_gemm_kernel|mlp_quant_kernel"),
    ("row 9 decode_step_fused", r"step_kernel<.*GenCacheAttn"),
    ("row 10 decode_step_serve", r"step_kernel<.*SlabAttn"),
    ("W8A8 GEMM (torch._int_mm)", r"gemm_s8|s8gemm|imma"),
    ("other library GEMMs", r"gemm|nvjet|xmma|cutlass"),
)
OTHER = "PyTorch elementwise, reductions and copies"
K1 = KERNEL_GROUPS[0][0]
W8A8 = "W8A8 GEMM (torch._int_mm)"
COPY_PREFIXES = ("Memcpy", "Memset")


class DeviceOp:
    __slots__ = ("name", "start", "end")

    def __init__(self, name, start, end):
        self.name, self.start, self.end = name, float(start), float(end)

    @property
    def ms(self):
        return (self.end - self.start) / 1e3


def group_of(name: str) -> str:
    return next((lb for lb, pat in KERNEL_GROUPS if re.search(pat, name)), OTHER)


def group_kernels(ops: List[DeviceOp]) -> Dict[str, List[float]]:
    """{group: [ms, calls]} over KERNEL_GROUPS then OTHER; copies and
    memsets count in OTHER. The groups add up to the summed device time."""
    groups = {label: [0.0, 0] for label, _ in KERNEL_GROUPS}
    groups[OTHER] = [0.0, 0]
    for op in ops:
        g = groups[group_of(op.name)]
        g[0] += op.ms
        g[1] += 1
    return groups


def is_kernel(op: DeviceOp) -> bool:
    return not op.name.startswith(COPY_PREFIXES)


def busy_intervals(ops: List[DeviceOp], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of the operations' intervals, clipped to [lo, hi] (us)."""
    spans = sorted((max(o.start, lo), min(o.end, hi)) for o in ops if o.end > lo and o.start < hi)
    out: List[List[float]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_gaps(busy: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def host_activity(cpu: List[Tuple[float, float, str]], gaps, top: int = 200) -> Dict[str, float]:
    """Seconds of the `top` longest idle gaps by what the host was doing at
    each gap's middle: the innermost host event (operator or runtime call)
    that spans it, else "host between operations"."""
    cpu = sorted(cpu)
    starts = [c[0] for c in cpu]
    out: Dict[str, float] = {}
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (s + e) / 2
        j = bisect.bisect_right(starts, mid)
        best: Optional[Tuple[float, str]] = None
        # the events that started before mid, latest first; an event that
        # spans mid and is shorter than the best so far is more inner
        for k in range(j - 1, max(j - 4000, -1), -1):
            cs, ce, name = cpu[k]
            if ce >= mid and (best is None or ce - cs < best[0]):
                best = (ce - cs, name)
        name = best[1] if best else "host between operations"
        out[name] = out.get(name, 0.0) + (e - s) / 1e6
    return out


def read_profile(prof, window_name: str):
    """(device ops, host events [(start, end, name)], (window start, end))
    of a profiled run whose traced window is the user annotation
    `window_name`; times in microseconds."""
    from torch.autograd import DeviceType

    win = None
    cpu = []
    ops = []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if (e.name.startswith("Command Buffer") or getattr(e, "is_user_annotation", False)
                    or e.name.startswith("Optimizer.")):
                continue
            ops.append(DeviceOp(e.name, tr.start, tr.end))
        elif e.name == window_name:
            win = (float(tr.start), float(tr.end))
        else:
            cpu.append((float(tr.start), float(tr.end), e.name))
    return ops, cpu, win
