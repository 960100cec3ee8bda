"""Optimizer and learning-rate schedule (JAX ``train/optim.py``).

- AdamW (or SGD with momentum) with the minGPT-style decay split: weight
  decay applies to conv / transposed conv / linear weights only; biases, norm affines and layer
  scales are excluded. The last ``hh_branch`` block is excluded too: the
  backbone discards its output, so its parameters never receive a gradient,
  torch skips a parameter without gradient altogether (decay included), and
  they stay at their initial values for the whole run.
- Linear warmup from 0 that reaches the base rate at step W - 1, then cosine
  annealing to ``eta_min`` (or multistep decay), stepped per iteration; the
  total includes the warmup epochs. The rate of a step is a closed form of
  the number of steps taken before it (0 for the first step, so warmup
  starts at rate 0), set on the optimizer before each update.
- Clipping by global norm in optax's form: scale by ``clip / norm`` when the
  norm is at least ``clip``, else leave the gradients as they are.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Set

import torch
from torch import nn


def decay_names(model: nn.Module) -> Set[str]:
    """Names of the parameters that decay: the weights of every conv,
    transposed conv and linear layer, except those of the last
    ``hh_branch`` block."""
    names = {f"{prefix}.weight" if prefix else "weight"
             for prefix, m in model.named_modules()
             if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d, nn.Linear))}
    hh = [int(m.group(1)) for n in names
          for m in [re.search(r"(?:^|\.)hh_branch\.(\d+)\.", n)] if m]
    if hh:
        last = f"hh_branch.{max(hh)}."
        names = {n for n in names if last not in n}
    return names


def make_schedule(opt_cfg: Dict, num_iters_per_epoch: int) -> Callable[[int], float]:
    """``schedule(count)``: the rate of the step taken after ``count`` steps."""
    base_lr = opt_cfg["learning_rate"]
    cosine = opt_cfg.get("schedule_type", "cosine") == "cosine"
    steps = [num_iters_per_epoch * s for s in opt_cfg.get("schedule_steps", [])]
    gamma = opt_cfg.get("schedule_gamma", 0.1)
    eta_min = opt_cfg.get("eta_min", 1e-8)
    if opt_cfg.get("warmup", True):
        warmup_steps = opt_cfg["warmup_epochs"] * num_iters_per_epoch
        max_steps = (opt_cfg["epochs"] + opt_cfg["warmup_epochs"]) * num_iters_per_epoch
        wdiv = float(max(warmup_steps - 1, 1))
        cos_div = float(max(max_steps - warmup_steps, 1))

        def sched(count):
            if count < warmup_steps:
                return min(count * (base_lr / wdiv), base_lr)
            if cosine:
                prog = (count - warmup_steps) / cos_div
                return eta_min + 0.5 * (base_lr - eta_min) * (1.0 + math.cos(math.pi * prog))
            # milestones count post-warmup steps
            return base_lr * gamma ** sum((count - warmup_steps) >= s for s in steps)

        return sched
    max_steps = opt_cfg["epochs"] * num_iters_per_epoch

    def sched(count):
        if cosine:
            alpha = eta_min / base_lr
            decay = 0.5 * (1.0 + math.cos(math.pi * min(count, max_steps) / max_steps))
            return base_lr * ((1.0 - alpha) * decay + alpha)
        return base_lr * gamma ** sum(count >= s for s in steps)

    return sched


class Optimizer:
    """A torch optimizer with its schedule and clipping: what the JAX
    package's optax chain holds. ``update(count)`` clips the gradients in
    place, sets the rate of step ``count`` and applies the update."""

    def __init__(self, inner: torch.optim.Optimizer, schedule, clip_grad_l2norm: float):
        self.inner, self.schedule, self.clip = inner, schedule, clip_grad_l2norm

    def params(self):
        return [p for g in self.inner.param_groups for p in g["params"]]

    def global_norm(self) -> torch.Tensor:
        """f32 scalar. The squares are summed in f64: an f32 norm over a
        tensor of millions of values is good to 1e-4 only on some backends."""
        grads = [p.grad for p in self.params() if p.grad is not None]
        norms = torch._foreach_norm(grads, 2.0, dtype=torch.float64)
        return torch.linalg.vector_norm(torch.stack(norms)).float()

    def update(self, count: int, grad_norm: torch.Tensor) -> None:
        if self.clip > 0:
            grads = [p.grad for p in self.params() if p.grad is not None]
            # (g / norm) * clip where norm >= clip, else g: no host sync
            scale = torch.where(grad_norm < self.clip, torch.ones_like(grad_norm),
                                self.clip / grad_norm)
            torch._foreach_mul_(grads, scale)
        lr = self.schedule(count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, sd):
        self.inner.load_state_dict(sd)


def make_optimizer(model: nn.Module, opt_cfg: Dict, num_iters_per_epoch: int,
                   clip_grad_l2norm: float = -1.0):
    """Returns (``Optimizer``, schedule). Two parameter groups, decay and no
    decay, at one rate, so that torch's decoupled decay ``p (1 - lr wd)``
    equals optax's ``- lr wd p`` on the masked tree."""
    schedule = make_schedule(opt_cfg, num_iters_per_epoch)
    wd = opt_cfg.get("weight_decay", 0.0)
    decay = decay_names(model)
    named = list(model.named_parameters())
    groups = [
        {"params": [p for n, p in named if n in decay], "weight_decay": wd},
        {"params": [p for n, p in named if n not in decay], "weight_decay": 0.0},
    ]
    lr = opt_cfg["learning_rate"]
    if opt_cfg.get("type", "AdamW") == "SGD":
        inner = torch.optim.SGD(groups, lr=lr, momentum=opt_cfg.get("momentum", 0.9))
    else:
        inner = torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return Optimizer(inner, schedule, clip_grad_l2norm), schedule
