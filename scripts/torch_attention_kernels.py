"""The attention kernels alone on one CUDA card: K2 (flash_attention), row 4
(flash_fwd_lse, flash_dq, flash_dkv), row 5 (flash_attention_lse) and row 6
(flash_attention_prefixed), through `chip_smoke.py`'s own checks.

For each checkout given (default: this one), in the order given, one
process in that checkout builds `flash_attention.cu` and
`flash_attention_vjp.cu`, prints each kernel's ptxas report, holds every
kernel against its plain version (the edge cases too, where that
checkout's `chip_smoke.py` has them) and times it at the stage-1 and
training shapes. Each process prints its phase lines and one JSON line of
kernel records; this script then prints a table of the times. Run two
checkouts as A, B, B, A to compare them on one card:

    python3 scripts/torch_attention_kernels.py [ROOT ...]
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
libs = ("flash_attention", "flash_attention_vjp")
kernels.build(libs)
if hasattr(cs, "report_ptxas"):
    cs.report_ptxas(kernels, libs)
dev = torch.device("cuda")
recs = [cs.check_flash_attention(dev, cs.ITERS)] + cs.check_flash_vjp(dev, cs.ITERS)
recs += cs.check_prefix_attention(dev, cs.ITERS)
if hasattr(cs, "check_flash_edges"):
    cs.check_flash_edges(dev)
print("RECORDS " + json.dumps(recs), flush=True)
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
                              text=True, timeout=900)
        print(f"== {root}", flush=True)
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-6000:], file=sys.stderr, flush=True)
            return proc.returncode
        line = next(x for x in proc.stdout.splitlines() if x.startswith("RECORDS "))
        recs = json.loads(line[len("RECORDS "):])
        table.append((root.name, {r["name"]: r for r in recs}))
    for label, recs in table:
        for name, r in recs.items():
            full = r.get("full", {})
            print(f"{label} {name}: {r['ms']:.4f} ms (library {r['library_ms']:.4f}, bound "
                  f"{r['bound_ms']:.4f})" + (f"; full length {full['ms']:.4f} ms (library "
                                             f"{full['library_ms']:.4f})" if full else ""))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
