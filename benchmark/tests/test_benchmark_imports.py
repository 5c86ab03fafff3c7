"""The import check, and what the benchmark's processes load."""

import subprocess
import sys
from pathlib import Path

import run as R

HERE = Path(__file__).resolve().parents[1]


def test_forbidden_modules_compares_whole_top_level_names():
    names = ["revisionllm_tpu_torch", "revisionllm_tpu_torch.ops.quant", "numpy", "jaxtyping",
             "flaxen.x"]
    assert R.forbidden_modules(names) == []
    assert R.forbidden_modules(names + ["revisionllm_tpu.ops", "jax.numpy", "jaxlib", "flax"]) \
        == ["flax", "jax.numpy", "jaxlib", "revisionllm_tpu.ops"]


def _loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=HERE.parent, timeout=600, check=True)
    return out.stdout.split()


def test_reference_loads_nothing_of_the_program():
    code = (f"import sys; sys.path[:0] = [{str(HERE)!r}, {str(HERE.parent)!r}]\n"
            "from benchlib.cell import module\n"
            "module('references', 'revisionllm')\n"
            "import benchlib.traffic, benchlib.trace, benchlib.roofline\n"
            "print(*sorted({m.split('.')[0] for m in sys.modules}))")
    loaded = _loaded_after(code)
    assert not {"revisionllm_tpu_torch", "revisionllm_tpu", "jax", "flax"} & set(loaded)


def test_a_run_loads_no_jax():
    code = (f"import sys; sys.path[:0] = [{str(HERE)!r}, {str(HERE.parent)!r}, "
            f"{str(HERE / 'tests')!r}]\n"
            "import run as R; R.prepare_environment()\n"
            "from small import small_cell\n"
            "w = 'glm2-6b.ground-1h'\n"
            "R.run_cell(w, 5, 0.2, False, device='cpu', cell=small_cell(w))\n"
            "print('FORBIDDEN', *R.forbidden_modules(list(sys.modules)))\n"
            "print('LOADED', 'revisionllm_tpu_torch' in sys.modules)")
    loaded = _loaded_after(code)
    assert loaded[loaded.index("FORBIDDEN") + 1] == "LOADED"
    assert loaded[-1] == "True"
