"""Same-card A/B of the training step between checkouts of the repository.

For each root given, in the order given, one process in that checkout
builds its kernels and runs its own `chip_smoke.py` training assembly
through `train_cli.main` (Vicuna-7B QLoRA, 32 layers, int8 base made from a
seed, sequence 2048, batch 1, remat, the synthetic corpus): a warm-up and
`--steps` timed loop steps, then `--profiled` more steps of
`trainer.make_train_step`, each under torch.profiler, for the device's busy
time (summed kernel time) and row 4's share of it. Each process prints one
JSON line; this script prints them and a summary. Run the two checkouts as
A, B, B, A so that drift on the host falls on both. Needs one CUDA card:

    python3 scripts/torch_train_ab.py PARENT CHANGE CHANGE PARENT [--steps 6]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, os, shutil, sys, tempfile, time
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke as cs
from revisionllm_tpu_torch.train import train_cli, trainer
from revisionllm_tpu_torch.utils import kernels

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
kernels.build()
dev = torch.device("cuda")
tmp = tempfile.mkdtemp(prefix="train_ab_")
marks = []

def on_step(step, batch, metrics):
    torch.cuda.synchronize()
    marks.append(time.perf_counter())

try:
    paths = cs._corpus(tmp)
    run, opt = train_cli.main(cs.train_argv(paths, os.path.join(tmp, "run"), STEPS + 1),
                              on_step=on_step)
finally:
    shutil.rmtree(tmp, ignore_errors=True)
steps = np.diff(marks) * 1e3
step_fn = trainer.make_train_step(run.llama_cfg, run.adapter_cfg, run.train_cfg, opt)
batch = run.batch([0])
gen = torch.Generator(device=dev).manual_seed(5)
busy, row4 = [], []
for _ in range(PROFILED):
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        step_fn(run.trainable, run.frozen, run.base, batch, gen)
        torch.cuda.synchronize()
    groups, _ = cs.group_kernels(cs.kernel_events(prof))
    busy.append(sum(ms for ms, _ in groups.values()))
    row4.append(sum(ms for label, (ms, _) in groups.items() if label.startswith("row 4")))
print(json.dumps({"step_ms": [float(x) for x in steps], "median_step_ms": float(np.median(steps)),
                  "busy_ms": busy, "row4_ms": row4}), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", help="checkouts of the repository, in run order")
    ap.add_argument("--steps", type=int, default=6, help="timed loop steps per process")
    ap.add_argument("--profiled", type=int, default=3, help="profiled steps per process")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    child = CHILD.replace("PROFILED", str(args.profiled)).replace("STEPS", str(args.steps))
    rows = []
    for root in args.roots:
        root = Path(root).resolve()
        proc = subprocess.run([sys.executable, "-c", child], cwd=root, capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-6000:], file=sys.stderr, flush=True)
            return proc.returncode
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        rows.append((root.name, row))
        print(f"{root.name}: {json.dumps(row)}", flush=True)
    for name, row in rows:
        print(f"{name}: loop step median {row['median_step_ms']:.1f} ms; device busy per step "
              f"{', '.join(f'{x:.1f}' for x in row['busy_ms'])} ms, of which row 4 "
              f"{', '.join(f'{x:.2f}' for x in row['row4_ms'])} ms", flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
