"""Same-card A/B of the stage-1 serving cell, or of configuration A or C,
between checkouts of the repository.

For each root given, in the order given, one process in that checkout
builds its kernels and runs its own `chip_smoke.py` stage-1 slice
(Vicuna-7B, 32 layers, int8 weights from seed 0, the 1-hour movie, 57
windows in one chunk of 64): a warm-up `ground_windows`, `--runs` timed
chunks, then `step_breakdown` (prefill and decode step: wall, host enqueue,
device busy). With `--config A` the slice runs under configuration A's
switches (`chip_smoke.CONFIGS`: REVISIONLLM_FUSED_MLP=1 and
REVISIONLLM_MEGAKERNEL=1, row 8 in every prefill layer, row 9 for every
decode step) and its breakdown times row 9's step; with `--config C` the
slice's int8 layers are packed on the card into the serving chunks by
`chip_smoke.packed_engine`, as phase_configs packs them (so every checkout
given must have that helper), and run under REVISIONLLM_SERVE=1, row 10 for
every decode step, which the breakdown times. Each process prints one
JSON line with its launches; this script prints them and a summary. Run the
two checkouts as A, B, B, A so that drift on the host falls on both. Needs
one CUDA card:

    python3 scripts/torch_stage1_ab.py PARENT CHANGE CHANGE PARENT [--runs 5] [--config A|C]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys, time
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke as cs
from revisionllm_tpu_torch.utils import kernels

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
kernels.build()
dev = torch.device("cuda")
conf = next((c for label, c in cs.CONFIGS.items() if label.split()[0] == __CONFIG__),
            {"env": {}, "step": "split"})
with cs.switched(conf["env"]):
    eng, movie, qf, qc = cs.slice_setup(dev)
    if conf.get("pack"):
        eng = cs.packed_engine(eng, dev)
    eng.ground_windows(movie, cs.SENTENCE, qf, qc, movie_key="movie0")
    torch.cuda.synchronize()
    res, launches, lat = cs.run_slice(eng, movie, qf, qc, RUNS)
    cs.check_result(res, 57)
    parts = cs.step_breakdown(eng, movie, qf, conf["step"])
parts = {k: v for k, v in parts.items() if isinstance(v, float)}
print(json.dumps({"latencies_ms": [x * 1e3 for x in lat],
                  "chunk_ms": float(np.median(lat)) * 1e3,
                  "launches": {k: n for k, n in launches.items() if n}, **parts}), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", help="checkouts of the repository, in run order")
    ap.add_argument("--runs", type=int, default=5, help="timed chunks per process")
    ap.add_argument("--config", choices=("stage1", "A", "C"), default="stage1",
                    help="the stage-1 cell, configuration A (rows 8 and 9) or C (row 10)")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    rows = []
    for root in args.roots:
        root = Path(root).resolve()
        child = CHILD.replace("RUNS", str(args.runs)).replace("__CONFIG__", repr(args.config))
        proc = subprocess.run([sys.executable, "-c", child],
                              cwd=root, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
            return proc.returncode
        rec = {"root": str(root), **json.loads(proc.stdout.strip().splitlines()[-1])}
        rows.append(rec)
        print(json.dumps(rec), flush=True)
    for rec in rows:
        print(f"{rec['root']}: chunk {rec['chunk_ms']:.1f} ms (runs "
              f"{', '.join(f'{x:.1f}' for x in rec['latencies_ms'])}); prefill wall "
              f"{rec['prefill_wall']:.2f} host {rec['prefill_host']:.2f} busy "
              f"{rec['prefill_busy']:.2f} ms; decode step wall {rec['step_wall']:.2f} host "
              f"{rec['step_host']:.2f} busy {rec['step_busy']:.2f} ms; 11 steps "
              f"{rec['steps_wall']:.1f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
