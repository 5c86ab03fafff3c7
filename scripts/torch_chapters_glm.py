#!/usr/bin/env python3
"""chip_smoke.py's K3 group-16 check, phase 18 (ChatGLM2-6B with P-tuning)
and phase 17 (the chapters adapter and the alternate train steps) alone,
on one GPU, after building the kernels:

    python3 scripts/torch_chapters_glm.py

About 2 minutes of command time against chip_smoke.py's 12. Prints what
those phases print (the card's name and power limit first) and exits
non-zero if one of them fails; each runs even if an earlier one failed.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_chapters_glm: CUDA is not available", file=sys.stderr)
        return 3
    import chip_smoke as C
    from revisionllm_tpu_torch.utils import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kernels.build()
    C.report_ptxas(kernels, ["decode_attention"])
    failed = []
    with tempfile.TemporaryDirectory(prefix="chapters_glm_") as tmp:
        steps = (
            ("K3 group 16", lambda: C.check_k3_group16(
                dev, torch.Generator(device=dev).manual_seed(5), C.ITERS)),
            ("phase 18", lambda: C.phase_glm(dev, tmp, smi)),
            ("phase 17", lambda: C.phase_chapters(dev, C._corpus(tmp), smi)),
        )
        for name, run in steps:
            t0 = time.perf_counter()
            try:
                run()
            except Exception:  # report it and go on to the next phase
                traceback.print_exc()
                failed.append(name)
            C.say(f"{name}: {time.perf_counter() - t0:.1f} s"
                  + (" FAILED" if name in failed else ""))
            torch.cuda.empty_cache()
    print(f"failed: {failed}" if failed else "all passed", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
