"""Row 7 (int4_matmul, csrc/int4_matmul.cu) alone on one CUDA card, through
`chip_smoke.py`'s own check.

For each checkout given (default: this one), in the order given, one
process in that checkout builds `int4_matmul.cu`, prints its ptxas report
(registers, shared memory, spills), and runs `chip_smoke.check_int4_matmul`:
the kernel against its plain version at the decode step's four shapes and
the edge cases that checkout's check has, and the times of one decode
step's 225 launches at M 64 beside torch.matmul on the dequantized bf16
weight. Each process prints its phase lines and one JSON line of the
kernel record; this script then prints a table of the times. Run two
checkouts as A, B, B, A to compare them on one card (about 30 s a
process):

    python3 scripts/torch_int4_kernel.py [ROOT ...]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from revisionllm_tpu_torch.utils import kernels

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
kernels.build(["int4_matmul"])
if hasattr(cs, "NO_SPILL_KERNELS"):
    cs.report_ptxas(kernels, ["int4_matmul"])
else:
    for entry in cs.ptxas_entries(kernels.library_path("int4_matmul").with_suffix(".log").read_text()):
        print("# ptxas int4_matmul %s: %d registers, %d B static shared memory, spill stores "
              "%d B, spill loads %d B" % entry, flush=True)
rec = cs.check_int4_matmul(torch.device("cuda"), cs.ITERS)
print("RECORDS " + json.dumps([rec]), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", help="checkouts of the repository, in run order")
    args = ap.parse_args()
    roots = args.roots or [str(Path(__file__).resolve().parent.parent)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    table = []
    for root in roots:
        root = Path(root).resolve()
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=root, capture_output=True,
                              text=True, timeout=600)
        print(f"== {root}", flush=True)
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-6000:], file=sys.stderr, flush=True)
            return proc.returncode
        line = next(x for x in proc.stdout.splitlines() if x.startswith("RECORDS "))
        table.append((str(root), json.loads(line[len("RECORDS "):])[0]))
    for label, r in table:
        shapes = ", ".join(f"{d['K']}x{d['N']} {d['ms'] * 1e3:.2f} us" for d in r["shapes"])
        print(f"{label} int4_matmul: {r['ms']:.4f} ms a decode step (library "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f}); at M 64: {shapes}")
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
