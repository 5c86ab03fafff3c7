"""The port stands alone: no module of revisionllm_tpu_torch (nor
chip_smoke.py) imports JAX or the JAX package; entry points refuse to run
without CUDA unless asked for the CPU; the host copies agree with the JAX
package's originals; the kernel build needs nvcc and chip_smoke.py refuses
to report without a GPU or outside a checkout."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import revisionllm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(revisionllm_tpu_torch.__path__, "revisionllm_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "revisionllm_tpu" or m.startswith("revisionllm_tpu."))
print(json.dumps({"imported": names, "bad": bad}))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for mod in ("ops.quant", "ops.flash_attention", "ops.decode_attention", "models.llama",
                "models.generation", "eval.engine", "models.weights", "utils.kernels",
                "models.lora", "train.trainer", "train.train_cli", "data.dataset"):
        assert f"revisionllm_tpu_torch.{mod}" in res["imported"]


def test_entry_points_raise_without_cuda(monkeypatch):
    from revisionllm_tpu_torch.config import AdapterConfig, EvalConfig, LlamaConfig
    from revisionllm_tpu_torch.eval.engine import GroundingEngine
    from revisionllm_tpu_torch.models import llama, revisionllm
    from revisionllm_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LlamaConfig.tiny()
    for call in (
        lambda: resolve_device(),
        lambda: llama.init_params(cfg),
        lambda: revisionllm.init_vision_params(AdapterConfig(d_model=16, hidden_size=128), d_in=16),
        lambda: GroundingEngine(cfg, AdapterConfig(), {}, {}, None, EvalConfig()),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert llama.init_params(cfg, device="cpu")["embed"].device.type == "cpu"


def test_host_copies_match_the_jax_package():
    from revisionllm_tpu import constants as jc
    from revisionllm_tpu import conversation as jconv
    from revisionllm_tpu import tokenization as jtok
    from revisionllm_tpu.config import AdapterConfig as JA, EvalConfig as JE, LlamaConfig as JL
    from revisionllm_tpu.eval import metrics as jm
    from revisionllm_tpu.utils.testing import FakeTokenizer as JF
    from revisionllm_tpu_torch import constants as tc
    from revisionllm_tpu_torch import conversation as tconv
    from revisionllm_tpu_torch import tokenization as ttok
    from revisionllm_tpu_torch.config import AdapterConfig as TA, EvalConfig as TE, LlamaConfig as TL
    from revisionllm_tpu_torch.eval import metrics as tm
    from revisionllm_tpu_torch.utils.testing import FakeTokenizer as TF

    assert tc.QUESTIONS == jc.QUESTIONS and tc.IMAGE_TOKEN_INDEX == jc.IMAGE_TOKEN_INDEX
    assert TL().__dict__ == JL().__dict__ and TL.tiny().__dict__ == JL.tiny().__dict__
    for T_, J_ in ((TA, JA), (TE, JE)):
        assert T_().__dict__ == J_().__dict__
    prompt = "<video>\n" + tc.QUESTIONS["mad_grounding"].format("a dog runs </s> away")
    t_prompt = tconv.CONV_VICUNA_V1.user_turn_prompt(prompt)
    assert t_prompt == jconv.CONV_VICUNA_V1.user_turn_prompt(prompt)
    assert tconv.CONV_VICUNA_V1.stop_str == jconv.CONV_VICUNA_V1.stop_str
    assert ttok.tokenizer_image_token(t_prompt, TF()) == jtok.tokenizer_image_token(t_prompt, JF())
    mem = "<video> then <memory> more"
    assert ttok.tokenizer_image_token(mem, TF()) == jtok.tokenizer_image_token(mem, JF())
    for text in ("From 12 to 40.", "3 and 9", "In video 7", "Not Present"):
        assert tm.parse_span(text) == jm.parse_span(text)
        assert tm.parse_single(text) == jm.parse_single(text)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    from revisionllm_tpu_torch.utils import kernels

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels._nvcc()
    for name in kernels.KERNELS:
        path = kernels.library_path(name)
        assert (kernels.CSRC / f"{name}.cu").is_file()
        assert path.parent == kernels.BUILD_DIR and path.name.startswith(name + "-")


def test_wrappers_count_nothing_on_the_cpu():
    """CPU tensors take the plain versions, which launch nothing."""
    from revisionllm_tpu_torch.ops import decode_attention, flash_attention, quant
    from revisionllm_tpu_torch.utils import kernels

    kernels.reset_launches()
    x = torch.randn(4, 32)
    q, s = quant.quantize_int8(torch.randn(32, 16))
    quant.int8_matmul(x, q, s)
    qkv = torch.randn(1, 8, 2, 32)
    flash_attention.flash_attention(qkv, qkv, qkv)
    g = torch.randn(1, 3, 2, 32)
    decode_attention.decode_attention(torch.randn(1, 2, 1, 32), qkv, qkv, None, None, g, g,
                                      torch.tensor([8]), 1)
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def test_chip_smoke_refuses_without_gpu_or_checkout(tmp_path):
    """No CUDA here: chip_smoke.py exits non-zero and prints no result line;
    alone in a directory it refuses before anything else."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, lone)):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
