"""Finding a cell's parts by name: BENCHMARK.json's entries, then
configs/<config>.json, traffic/<mix>.json, families/<family>.py,
drivers/<driver>.py, references/<reference>.py, metrics/<metric>.py and
limits/<workload>.json under the benchmark's folder."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]          # the benchmark's folder
ROOT = HERE.parent                                  # the checkout


def load_json(path):
    with open(path) as f:
        return json.load(f)


def module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}".replace(".", "_")
                                                  .replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark_spec():
    return load_json(ROOT / "BENCHMARK.json")


def cell(workload: str, spec=None):
    """Everything one workload needs, by name: {"workload", "config",
    "dims", "adapter", "traffic", "limits", "end_to_end", "per_layer"}."""
    spec = spec or benchmark_spec()
    w = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if w is None:
        raise SystemExit(f"no workload named {workload!r} in BENCHMARK.json")
    cfg = load_json(HERE / "configs" / f"{w['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits_path = HERE / "limits" / f"{workload}.json"

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return {
        "workload": w,
        "config": cfg,
        "dims": module("families", cfg["family"]).dims(cfg),
        "adapter": cfg["adapter"],
        "traffic": traffic,
        "limits": load_json(limits_path) if limits_path.exists() else {},
        "end_to_end": [m for m in spec["end_to_end"] if applies(m)],
        "per_layer": [m for m in spec["per_layer"] if applies(m)],
    }
