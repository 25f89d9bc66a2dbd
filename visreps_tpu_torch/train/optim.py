"""Optimizer, learning-rate table and loss (port of
``visreps_tpu/train/optim.py:25-118``).

The JAX package's optax chain, step for step:

  * per-epoch schedules (steplr, multisteplr, cosine with eta_min = 5 %
    of the base rate, each with an optional linear warmup from 0.25×),
    read per step as ``table[min(step // steps_per_epoch, num_epochs)]``;
  * ``clip_by_global_norm`` over the trainable gradients: ``g`` where
    ‖g‖ < c, else ``g / ‖g‖ · c`` (``torch.nn.utils.clip_grad_norm_``
    divides by ‖g‖ + 1e-6 instead);
  * adamw with weight decay on parameters with ndim > 1 only, adam, or
    sgd with momentum 0.9;
  * frozen layers (``trainable_mask``) are left out of the optimizer:
    no update, no decay, no state — optax's ``set_to_zero`` branch —
    while the reported gradient norm still spans every gradient.
"""
from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn


def lr_at_epoch(cfg, completed_epochs: int) -> float:
    """Reference scheduler value after ``completed_epochs`` steps."""
    base = cfg.learning_rate
    warmup = cfg.get("warmup_epochs", 0)
    total = cfg.num_epochs
    t_max = total - warmup if warmup > 0 else total
    name = cfg.get("lr_scheduler", "cosineannealinglr").lower()

    if warmup > 0 and completed_epochs < warmup:
        return base * (0.25 + 0.75 * completed_epochs / warmup)
    t = completed_epochs - warmup if warmup > 0 else completed_epochs

    if name == "steplr":
        return base * (0.1 ** (t // 10))
    if name == "multisteplr":
        milestones = [int(t_max * 0.3), int(t_max * 0.6), int(t_max * 0.9)]
        return base * (0.1 ** sum(t >= m for m in milestones))
    if name == "cosineannealinglr":
        eta_min = base * 0.05
        return eta_min + (base - eta_min) * (1 + math.cos(math.pi * t / t_max)) / 2
    raise ValueError(f"Invalid LR scheduler name: {name}")


def global_norm(tensors) -> torch.Tensor:
    """√Σ‖t‖² over the tensors, in float32, on their device."""
    return torch.sqrt(sum(torch.sum(t.to(torch.float32) ** 2) for t in tensors))


class Optimizer:
    """The optax chain of ``setup_optimizer`` over a model's parameters.

    ``step(global_step)`` reads the gradients left by ``backward``,
    clips the trainable ones, sets the step's learning rate and updates;
    it returns the pre-clip global norm of all gradients as a device
    tensor (no host sync).
    """

    def __init__(self, model: nn.Module, cfg, steps_per_epoch: int,
                 trainable_mask: Mapping[str, bool] | None = None):
        self.steps_per_epoch = steps_per_epoch
        self.num_epochs = cfg.num_epochs
        self.table = [lr_at_epoch(cfg, e) for e in range(cfg.num_epochs + 1)]
        self.grad_clip = cfg.get("grad_clip", 0) or 0
        mask = dict(trainable_mask or {})
        named = list(model.named_parameters())
        self.params = [p for _, p in named]
        self.trainable = [p for name, p in named if mask.get(name.split(".")[0], True)]
        self.all_trainable = len(self.trainable) == len(self.params)
        name = cfg.optimizer.lower()
        lr = self.table[0]
        if name == "adamw":
            wd = cfg.get("weight_decay", 0.0)
            groups = [{"params": [p for p in self.trainable if p.ndim > 1], "weight_decay": wd},
                      {"params": [p for p in self.trainable if p.ndim <= 1], "weight_decay": 0.0}]
            groups = [g for g in groups if g["params"]]
            self.opt = torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        elif name == "adam":
            self.opt = torch.optim.Adam(self.trainable, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        elif name == "sgd":
            self.opt = torch.optim.SGD(self.trainable, lr=lr, momentum=0.9)
        else:
            raise ValueError(f"Unknown optimizer: {cfg.optimizer}")

    def lr_at_step(self, step: int) -> float:
        return self.table[min(step // self.steps_per_epoch, self.num_epochs)]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, global_step: int) -> torch.Tensor:
        grad_norm = global_norm([p.grad for p in self.params])
        if self.grad_clip > 0:
            grads = [p.grad for p in self.trainable]
            norm = grad_norm if self.all_trainable else global_norm(grads)
            keep = norm < self.grad_clip
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.grad_clip))
        lr = self.lr_at_step(global_step)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        return grad_norm


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       label_smoothing: float = 0.1) -> torch.Tensor:
    """Label-smoothed softmax cross-entropy, mean over the batch."""
    return F.cross_entropy(logits.to(torch.float32), labels, label_smoothing=label_smoothing)
