"""Checkpoint save/load and reference artifact export.

Counterpart of revisionllm_tpu/train/checkpoint.py with torch.save in place
of orbax. A checkpoint is the directory `checkpoint-<step>` (JAX's naming)
holding `state.pt`, the host copy of {"trainable", "opt_state", "step"}. It
is written under a temporary name and renamed into place, so
`latest_checkpoint` never sees a partial save.

`save_checkpoint(..., block=False)` overlaps the save with the next train
steps: the state is first cloned on the device (the train step updates the
trainable tensors in place), at most one such snapshot lives at a time, and
a background thread copies it to the host and writes it. Errors surface in
`wait_for_checkpoints`, which callers call before restoring a step saved in
the same process; the thread is joined at interpreter exit, so an unclean
exit still commits the save.

`export_reference_artifacts` writes the reference's on-disk layout
(train/train.py:402-412): adapter_model.bin + adapter_config.json (PEFT
LoRA) and non_lora_trainables.bin (the ClipEncoder adapter), with JAX's
keys, shapes and dtypes.

Under torch.distributed only rank 0 writes (the ranks hold the same
trainable state); every rank may restore.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import torch

from revisionllm_tpu_torch.config import LoraConfig
from revisionllm_tpu_torch.parallel.launch import is_main_process

_PENDING_SAVES: list = []
_SAVE_ERRORS: list = []


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _write(ckpt_dir: str, host_state) -> None:
    tmp = f"{ckpt_dir}.tmp-{os.getpid()}-{threading.get_ident()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(host_state, os.path.join(tmp, "state.pt"))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    os.replace(tmp, ckpt_dir)


def save_checkpoint(path: str, state: Dict[str, Any], step: int, block: bool = True) -> None:
    """Save {trainable, opt_state, step} to `path/checkpoint-<step>` (rank 0
    alone under torch.distributed)."""
    if not is_main_process():
        return
    ckpt_dir = os.path.join(os.path.abspath(path), f"checkpoint-{step}")
    if block:
        _write(ckpt_dir, _map(state, lambda t: t.detach().cpu()))
        return
    # at most one live snapshot: join a still-draining save first
    while _PENDING_SAVES:
        _PENDING_SAVES.pop().join()
    snap = _map(state, lambda t: t.detach().clone())

    def _bg():
        try:
            _write(ckpt_dir, _map(snap, lambda t: t.cpu()))
        except Exception as e:  # surfaced by wait_for_checkpoints
            _SAVE_ERRORS.append((ckpt_dir, e))

    # not a daemon: the interpreter joins it at exit, so a run that ends
    # without wait_for_checkpoints (an exception) still commits its save
    t = threading.Thread(target=_bg, daemon=False, name=f"ckpt-save-{step}")
    t.start()
    _PENDING_SAVES.append(t)


def wait_for_checkpoints() -> None:
    """Block until every pending async save has committed; re-raise the
    first background failure (a silently dropped checkpoint would defeat
    auto-resume)."""
    while _PENDING_SAVES:
        _PENDING_SAVES.pop().join()
    if _SAVE_ERRORS:
        ckpt_dir, err = _SAVE_ERRORS.pop(0)
        _SAVE_ERRORS.clear()
        raise RuntimeError(f"async checkpoint save failed for {ckpt_dir}") from err


def latest_checkpoint(path: str) -> Optional[str]:
    if not os.path.isdir(path):
        return None
    steps = []
    for name in os.listdir(path):
        if name.startswith("checkpoint-"):
            try:
                steps.append(int(name.split("-", 1)[1]))
            except ValueError:
                pass
    if not steps:
        return None
    return os.path.join(path, f"checkpoint-{max(steps)}")


def restore_checkpoint(ckpt_dir: str, template: Dict[str, Any]) -> Dict[str, Any]:
    """The saved state, its "trainable" tensors placed on the device and in
    the type of the matching `template` tensors (fresh tensors; the
    optimizer state stays as saved, on the host, for load_state_dict)."""
    state = torch.load(os.path.join(ckpt_dir, "state.pt"), map_location="cpu", weights_only=True)

    def place(saved, tmpl):
        if isinstance(saved, dict):
            return {k: place(v, tmpl[k]) for k, v in saved.items()}
        if isinstance(saved, (list, tuple)):
            return type(saved)(place(s, t) for s, t in zip(saved, tmpl))
        return saved.to(device=tmpl.device, dtype=tmpl.dtype)

    state["trainable"] = place(state["trainable"], template["trainable"])
    return state


# ---------------------------------------------------------------------------
# Reference-format export
# ---------------------------------------------------------------------------

_PEFT_NAME = "base_model.model.model.layers.{i}.self_attn.{name}.lora_{ab}.weight"
_PEFT_MLP_NAME = "base_model.model.model.layers.{i}.mlp.{name}.lora_{ab}.weight"


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.detach().cpu().contiguous()


def export_reference_artifacts(
    out_dir: str,
    lora: Optional[Dict[str, Any]],
    lora_cfg: Optional[LoraConfig],
    vision: Optional[Dict[str, Any]] = None,
) -> None:
    """Write adapter_model.bin + adapter_config.json + non_lora_trainables.bin
    in the reference's on-disk format (rank 0 alone under
    torch.distributed)."""
    if not is_main_process():
        return
    os.makedirs(out_dir, exist_ok=True)
    if lora is not None and lora_cfg is not None:
        state = {}
        attn = {"q_proj", "k_proj", "v_proj", "o_proj"}
        for name, mats in lora["layers"].items():
            a, b = mats["a"], mats["b"]  # [L, in, r], [L, r, out]
            tmpl = _PEFT_NAME if name in attn else _PEFT_MLP_NAME
            for i in range(a.shape[0]):
                state[tmpl.format(i=i, name=name, ab="A")] = _t(a[i].T)
                state[tmpl.format(i=i, name=name, ab="B")] = _t(b[i].T)
        torch.save(state, os.path.join(out_dir, "adapter_model.bin"))
        with open(os.path.join(out_dir, "adapter_config.json"), "w") as f:
            json.dump(
                {
                    "peft_type": "LORA",
                    "r": lora_cfg.r,
                    "lora_alpha": lora_cfg.alpha,
                    "lora_dropout": lora_cfg.dropout,
                    "target_modules": list(lora_cfg.target_patterns),
                    "bias": "none",
                    "task_type": "CAUSAL_LM",
                },
                f,
            )

    if vision is not None:
        state = {}
        _export_vision(state, vision["mm_projector"], "model.mm_projector")
        torch.save(state, os.path.join(out_dir, "non_lora_trainables.bin"))


def _export_vision(state: dict, tree: Dict[str, Any], prefix: str) -> None:
    """The adapter tree -> reference ClipEncoder state-dict names."""
    if "w" in tree and "b" in tree and len(tree) == 2:  # plain mlp projector
        state[f"{prefix}.weight"] = _t(tree["w"].T)
        state[f"{prefix}.bias"] = _t(tree["b"])
        return

    state[f"{prefix}.global_rep_token"] = _t(tree["global_token"])
    state[f"{prefix}.global_rep_pos"] = _t(tree["global_pos"])

    def export_layers(layers, enc_name):
        for i, layer in enumerate(layers):
            lp = f"{prefix}.{enc_name}.layers.{i}"
            wq, wk, wv = (layer[k]["w"].T for k in ("wq", "wk", "wv"))
            bq, bk, bv = (layer[k]["b"] for k in ("wq", "wk", "wv"))
            state[f"{lp}.self_attn.in_proj_weight"] = _t(torch.cat([wq, wk, wv], 0))
            state[f"{lp}.self_attn.in_proj_bias"] = _t(torch.cat([bq, bk, bv], 0))
            state[f"{lp}.self_attn.out_proj.weight"] = _t(layer["wo"]["w"].T)
            state[f"{lp}.self_attn.out_proj.bias"] = _t(layer["wo"]["b"])
            state[f"{lp}.linear1.weight"] = _t(layer["ffn1"]["w"].T)
            state[f"{lp}.linear1.bias"] = _t(layer["ffn1"]["b"])
            state[f"{lp}.linear2.weight"] = _t(layer["ffn2"]["w"].T)
            state[f"{lp}.linear2.bias"] = _t(layer["ffn2"]["b"])
            state[f"{lp}.norm1.weight"] = _t(layer["norm1_w"])
            state[f"{lp}.norm1.bias"] = _t(layer["norm1_b"])
            state[f"{lp}.norm2.weight"] = _t(layer["norm2_w"])
            state[f"{lp}.norm2.bias"] = _t(layer["norm2_b"])

    export_layers(tree["enc_layers"], "encoder")
    if "t2v_layers" in tree:
        export_layers(tree["t2v_layers"], "t2v_encoder")
    if "mm_projector" in tree:
        state[f"{prefix}.mm_projector.weight"] = _t(tree["mm_projector"]["w"].T)
        state[f"{prefix}.mm_projector.bias"] = _t(tree["mm_projector"]["b"])
    if "text_proj" in tree:  # the chapters adapter's query projection
        state[f"{prefix}.text_mm_projector.weight"] = _t(tree["text_proj"]["w"].T)
        state[f"{prefix}.text_mm_projector.bias"] = _t(tree["text_proj"]["b"])
