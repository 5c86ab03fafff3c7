"""Same-card comparison of where `chip_smoke.py`'s whole run spends its
time, between checkouts of the repository.

For each root given, in the order given, one process runs that checkout's
own `chip_smoke.py` from its root. Every line it prints is written, with
the seconds since the process started, to `--out`/run{i}.log (its standard
error to run{i}.err). The seconds are then summed by tag: a phase line
"# slice: ..." has the tag "slice", the first word of its message, and the
time between two lines goes to the tag of the second, the line that
reports the work. Prints one table: a row a tag in the order of first
appearance, a column a run, then each run's whole time, its exit code and
its last line. Exits non-zero when a run did. Run the two checkouts as A,
B, B, A so that drift on the host falls on both. Needs one CUDA card:

    python3 scripts/torch_phase_times.py --out build/phase_times PARENT CHANGE CHANGE PARENT
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path


def tag(line: str) -> str:
    """The tag of one output line: the first word of a "# ..." phase line
    (without its colon), else "other" (the nvidia-smi line, the JSON
    lines)."""
    words = line[2:].split()
    return words[0].rstrip(":") if line.startswith("# ") and words else "other"


def by_tag(stamped):
    """{tag: seconds} over [(seconds since the start, line)], in the order
    of each tag's first line; the time before a line goes to its tag."""
    out, last = {}, 0.0
    for t, line in stamped:
        key = tag(line)
        out[key] = out.get(key, 0.0) + t - last
        last = t
    return out


def run(root: Path, log: Path):
    """Run root's chip_smoke.py; returns ([(seconds, line)], exit code, whole
    seconds)."""
    env = {**os.environ, "PYTHONUNBUFFERED": "1"}
    stamped = []
    t0 = time.perf_counter()
    with open(log.with_suffix(".err"), "w") as err, open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=root, env=env,
                                stdout=subprocess.PIPE, stderr=err, text=True)
        for line in proc.stdout:
            t = time.perf_counter() - t0
            stamped.append((t, line.rstrip("\n")))
            f.write(f"{t:9.2f} {line}")
            f.flush()
        rc = proc.wait()
    return stamped, rc, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", type=Path, help="checkouts, in the order to run them")
    ap.add_argument("--out", type=Path, required=True, help="directory for the stamped logs")
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, root in enumerate(args.roots):
        stamped, rc, secs = run(root.resolve(), args.out / f"run{i}.log")
        print(f"run {i} ({root}): exit {rc}, {secs:.1f} s", flush=True)
        runs.append((by_tag(stamped), rc, secs, stamped[-1][1] if stamped else ""))
    tags = list(dict.fromkeys(k for r in runs for k in r[0]))
    print("tag".ljust(20) + "".join(f"{'run ' + str(i):>10}" for i in range(len(runs))))
    for k in tags:
        print(k[:19].ljust(20) + "".join(f"{r[0].get(k, 0.0):10.1f}" for r in runs))
    print("whole".ljust(20) + "".join(f"{r[2]:10.1f}" for r in runs))
    for i, (root, r) in enumerate(zip(args.roots, runs)):
        print(f"run {i} ({root}): exit {r[1]}; last line {r[3]}")
    return int(any(r[1] != 0 for r in runs))


if __name__ == "__main__":
    sys.exit(main())
