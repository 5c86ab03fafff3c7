"""The port stands alone: no module of revisionllm_tpu_torch (nor
chip_smoke.py) imports JAX or the JAX package, nor at import time a package
the GPU's machine lacks (transformers, tokenizers, safetensors, ml_dtypes,
gradio, h5py, cv2); entry points refuse to run without CUDA unless asked for the CPU;
the host copies agree with the JAX package's originals; the kernel build
needs nvcc and chip_smoke.py refuses to report without a GPU or outside a
checkout."""

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
absent = sorted(m for m in sys.modules
                if m.split(".")[0] in ("transformers", "tokenizers", "safetensors", "ml_dtypes",
                                       "gradio", "h5py", "cv2"))
print(json.dumps({"imported": names, "bad": bad, "absent": absent}))
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
    assert res["absent"] == []
    for mod in ("ops.quant", "ops.flash_attention", "ops.decode_attention", "models.llama",
                "models.generation", "eval.engine", "models.weights", "utils.kernels",
                "models.lora", "train.trainer", "train.train_cli", "data.dataset",
                "ops.windows", "models.revisionllm", "models.adapter", "eval.metrics",
                "eval.stage1", "eval.stage2", "eval.fusion", "eval.loader",
                "data.prefetcher", "utils.cli", "ops.decode_step", "ops.decode_serve",
                "models.convert", "data.synthetic", "tokenization", "inference", "demo",
                "webdemo", "eval.uncertainty", "eval.captioning", "eval.msrvtt",
                "eval.window_recall", "eval.merge_results", "data.stream", "models.clip",
                "data.video_reader", "data.feature_extraction", "data.native_store",
                "data.analysis", "data.debug_dataset", "data.converters",
                "ops.linear_attention", "models.prefix", "tokenization_glm", "utils.spm",
                "parallel.launch", "parallel.mesh", "parallel.comm", "parallel.sharding",
                "parallel.serve", "parallel.dryrun", "ops.moe", "models.deepseek_v2_reference"):
        assert f"revisionllm_tpu_torch.{mod}" in res["imported"]


def test_entry_points_raise_without_cuda(monkeypatch):
    from revisionllm_tpu_torch.config import AdapterConfig, EvalConfig, LlamaConfig
    from revisionllm_tpu_torch.data.feature_extraction import ClipFeatureExtractor
    from revisionllm_tpu_torch.data.prefetcher import DevicePrefetcher
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
        lambda: ClipFeatureExtractor({}),
        lambda: DevicePrefetcher([]),
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
    assert tc.PREFIX == jc.PREFIX and tc.MEMORY_TOKEN_INDEX == jc.MEMORY_TOKEN_INDEX
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
    answers = ["From 12 to 40.", "Not Present", "From 249 to 249", "From 5 to 5"]
    for plus in (False, True):
        assert tm.stage1_iou(answers, (0.1, 0.3), 250, 1000, [0.5, 0.2, 0.9, 0.1], plus) == \
            jm.stage1_iou(answers, (0.1, 0.3), 250, 1000, [0.5, 0.2, 0.9, 0.1], plus)


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
    flash_attention.flash_attention_lse(qkv, g, g, causal=False)
    flash_attention.flash_attention_prefixed(qkv, qkv, qkv, g[:, :2], g[:, :2])
    q4, s4 = quant.quantize_int4(torch.randn(128, 16))
    quant.int4_matmul(torch.randn(4, 128), q4, s4)
    xq, xs = quant.quantize_activation_rows(torch.randn(4, 32))
    quant.w8a8_mlp_fused(xq, xs, q, s, q, s)
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def test_megakernel_takes_its_plain_version_on_the_cpu():
    """ops/decode_step.py: a CPU tensor runs the plain version, launches
    nothing and writes this step's k/v into gen slot `step` only."""
    from revisionllm_tpu_torch.config import LlamaConfig
    from revisionllm_tpu_torch.models import llama
    from revisionllm_tpu_torch.ops import decode_step
    from revisionllm_tpu_torch.ops.rope import rope_angles
    from revisionllm_tpu_torch.utils import kernels

    cfg = LlamaConfig(vocab_size=64, hidden_size=256, intermediate_size=256, num_layers=1,
                      num_heads=2, num_kv_heads=2, head_dim=128)
    params = llama.init_params(cfg, seed=0, dtype=torch.float32, device="cpu", quantize=True)
    lens = torch.tensor([5, 3])
    pkv = {"kv": torch.randint(-127, 128, (1, 2, 2, 2, 5, 128), dtype=torch.int8),
           "kvsc": torch.rand(1, 2, 2, 2, 5) * 0.02}
    gen = decode_step.init_gen_cache(1, 2, 2, 128, 3, torch.float32)
    cos, sin = (t[:, 0] for t in rope_angles((lens + 1)[:, None], 128))
    kernels.reset_launches()
    hidden, gen = decode_step.decode_step_fused(params, pkv, gen, lens, 1, torch.randn(2, 256),
                                                cos, sin)
    assert hidden.shape == (2, 256) and hidden.isfinite().all() and gen.shape[4] == 8
    assert gen[:, :, :, :, 1].abs().sum() > 0
    assert not gen[:, :, :, :, 0].any() and not gen[:, :, :, :, 2:].any()
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
