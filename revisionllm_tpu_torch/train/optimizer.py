"""Optimizer and LR schedule.

Counterpart of revisionllm_tpu/train/optimizer.py: AdamW (b1 0.9, b2 0.999,
eps 1e-8, decoupled weight decay) over the trainable leaves, with optax's
linear-warmup + cosine-decay schedule (or warmup + constant) computed value
for value, and optax.MultiSteps gradient accumulation. As in optax, the
schedule is read at the count of updates applied so far, so the first
update uses schedule(0), which is 0 after a warmup from 0.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch

from revisionllm_tpu_torch.config import TrainConfig

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    # optax.linear_schedule (polynomial_schedule with power 1)
    def f(count: int) -> float:
        c = min(max(count, 0), steps)
        return (init - end) * (1.0 - c / steps) + end

    return f


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    # optax.cosine_decay_schedule
    def f(count: int) -> float:
        c = min(count, decay_steps)
        return init * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps)) + alpha)

    return f


def _join(schedules: List[Schedule], boundaries: List[int]) -> Schedule:
    # optax.join_schedules: schedule i runs from boundary i - 1, counted
    # from that boundary
    def f(count: int) -> float:
        i = sum(count >= b for b in boundaries)
        start = boundaries[i - 1] if i else 0
        return schedules[i](count - start)

    return f


def cosine_schedule(cfg: TrainConfig, total_steps: int) -> Schedule:
    warmup = max(int(cfg.warmup_ratio * total_steps), 1)
    if cfg.lr_scheduler == "cosine":
        # optax.warmup_cosine_decay_schedule(0, lr, warmup, max(total,
        # warmup + 1), end 0)
        decay = max(total_steps, warmup + 1)
        return _join([_linear(0.0, cfg.learning_rate, warmup),
                      _cosine(cfg.learning_rate, decay - warmup, 0.0)], [warmup])
    if cfg.lr_scheduler == "constant":
        return _join([_linear(0.0, cfg.learning_rate, warmup),
                      lambda count: cfg.learning_rate], [warmup])
    raise ValueError(f"unknown scheduler {cfg.lr_scheduler!r}")


class AdamW:
    """torch.optim.AdamW (foreach=False) over `params` with the schedule set
    before each update, and MultiSteps accumulation: with
    gradient_accumulation = k, the running mean of k micro-batch gradients
    is applied on every k-th call and the parameters stay put in between."""

    def __init__(self, params: List[torch.Tensor], cfg: TrainConfig, total_steps: int):
        self.params = list(params)
        self.schedule = cosine_schedule(cfg, total_steps)
        self.every_k = max(int(cfg.gradient_accumulation), 1)
        self.opt = torch.optim.AdamW(
            self.params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.weight_decay, foreach=False,
        )
        self.count = 0       # updates applied (the schedule's step)
        self.mini_step = 0   # micro-batches accumulated towards the next update
        self.acc = [torch.zeros_like(p) for p in self.params] if self.every_k > 1 else None

    def step(self, grads: List[torch.Tensor]) -> bool:
        """Take this micro-batch's gradients (one per param); returns whether
        the parameters were updated."""
        if self.acc is not None:
            self.mini_step += 1
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / self.mini_step)
            if self.mini_step < self.every_k:
                return False
            grads = self.acc
        for p, g in zip(self.params, grads):
            p.grad = g.to(p.dtype)
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        for p in self.params:
            p.grad = None
        self.count += 1
        if self.acc is not None:
            self.mini_step = 0
            for a in self.acc:
                a.zero_()
        return True

    def state_dict(self) -> Dict:
        return {"adamw": self.opt.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: Dict) -> None:
        self.opt.load_state_dict(state["adamw"])
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        if self.acc is not None:
            for a, s in zip(self.acc, state["acc"]):
                a.copy_(s)
