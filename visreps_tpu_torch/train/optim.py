"""Optimizer, learning-rate table and loss (port of
``visreps_tpu/train/optim.py:25-118``).

The JAX package's optax chain, step for step:

  * per-epoch schedules (steplr, multisteplr, cosine with eta_min = 5 %
    of the base rate, each with an optional linear warmup from 0.25×),
    read per step as ``table[min(step // steps_per_epoch, num_epochs)]``;
  * ``clip_by_global_norm`` over the trainable gradients: ``g`` where
    ‖g‖ < c, else ``g / ‖g‖ · c`` (``torch.nn.utils.clip_grad_norm_``
    divides by ‖g‖ + 1e-6 instead);
  * adamw with weight decay on parameters with ndim > 1 in the Flax
    layout only (``models/convert.flax_ndim``: a ViT's query/key/value
    biases are (heads, head_dim) there and decay), adam, or sgd with
    momentum 0.9;
  * frozen layers (``trainable_mask``) are left out of the optimizer:
    no update, no decay, no state — optax's ``set_to_zero`` branch —
    while the reported gradient norm still spans every gradient.

Its state goes out and comes back by parameter name (``named_state`` /
``load_named_state``), the form ``train/checkpoint.py`` writes for a
mid-training resume and maps the JAX package's optax state onto.
"""
from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from visreps_tpu_torch.models.convert import flax_ndim


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
        self.trainable_names = [name for name, _ in named if mask.get(name.split(".")[0], True)]
        by_name = dict(named)
        self.trainable = [by_name[name] for name in self.trainable_names]
        self.all_trainable = len(self.trainable) == len(self.params)
        name = self.name = cfg.optimizer.lower()
        lr = self.table[0]
        if name == "adamw":
            wd = cfg.get("weight_decay", 0.0)
            decays = [flax_ndim(n, p) > 1 for n, p in zip(self.trainable_names, self.trainable)]
            groups = [{"params": [p for p, d in zip(self.trainable, decays) if d],
                       "weight_decay": wd},
                      {"params": [p for p, d in zip(self.trainable, decays) if not d],
                       "weight_decay": 0.0}]
            groups = [g for g in groups if g["params"]]
            self.opt = torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        elif name == "adam":
            self.opt = torch.optim.Adam(self.trainable, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        elif name == "sgd":
            self.opt = torch.optim.SGD(self.trainable, lr=lr, momentum=0.9)
        else:
            raise ValueError(f"Unknown optimizer: {cfg.optimizer}")

    #: The per-parameter state entries of each optimizer.
    STATE_KEYS = {"adamw": ("step", "exp_avg", "exp_avg_sq"),
                  "adam": ("step", "exp_avg", "exp_avg_sq"),
                  "sgd": ("momentum_buffer",)}

    def named_state(self) -> dict[str, dict[str, torch.Tensor]]:
        """{trainable parameter name: its state entries}; empty before the
        first step."""
        return {name: dict(self.opt.state[p]) for name, p in
                zip(self.trainable_names, self.trainable) if p in self.opt.state}

    def load_named_state(self, state: Mapping[str, Mapping[str, torch.Tensor]]) -> None:
        """Set the state of every trainable parameter from ``state`` (as
        ``named_state`` gives it): exactly the trainable names, each with
        this optimizer's entries in its parameter's shape. Moments go to
        the parameter's device and dtype; Adam's ``step`` stays a float32
        scalar on the CPU, where ``torch.optim`` keeps it."""
        if set(state) != set(self.trainable_names):
            missing = sorted(set(self.trainable_names) - set(state))
            extra = sorted(set(state) - set(self.trainable_names))
            raise ValueError(f"optimizer state does not match the trainable parameters: "
                             f"missing {missing[:5]}, unexpected {extra[:5]}")
        keys = self.STATE_KEYS[self.name]
        for name, p in zip(self.trainable_names, self.trainable):
            entry = state[name]
            if set(entry) != set(keys):
                raise ValueError(f"{name}: {self.name} state needs {keys}, got {sorted(entry)}")
            loaded = {}
            for key, value in entry.items():
                value = torch.as_tensor(value)
                if key == "step":
                    loaded[key] = value.detach().to("cpu", torch.float32).reshape(())
                elif value.shape != p.shape:
                    raise ValueError(f"{name}.{key}: shape {tuple(value.shape)}, "
                                     f"parameter {tuple(p.shape)}")
                else:
                    loaded[key] = value.detach().to(p.device, p.dtype).clone()
            self.opt.state[p] = loaded

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
