"""Model building blocks with activation taps (port of
``visreps_tpu/models/layers.py:18-67, 70-173``).

``nn.BatchNorm2d/1d`` already have the semantics the JAX package's
``TorchBatchNorm`` copies (momentum 0.1, eps 1e-5, normalise with the
biased batch variance, update the running variance with the unbiased
one). The one difference is a dense batch of one row in training mode:
torch raises, the JAX package returns ``bias`` (x − mean = 0) and keeps
the update finite with ``n / max(n − 1, 1)``. ``BatchNorm1d`` below does
the same.

The initialisers draw from an explicit ``torch.Generator`` and follow
the JAX package's families: Flax's defaults (lecun-normal truncated
kernels, zero biases, unit norm scales), He-normal fan_out where a
module asks for it, xavier-uniform classifier heads. The pools
(VALID max / average, torch's adaptive average) are ``torch.nn.functional``'s
own; the ResNet stem's −inf-padded 3×3/2 max pool is
``F.max_pool2d(x, 3, 2, padding=1)``.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

#: Called with (tap name, value) at each tap point of a forward.
TapFn = Callable[[str, torch.Tensor], None]

# Flax's truncated-normal initialisers divide the stddev by the std of a
# unit normal truncated to [-2, 2], so the truncated draw keeps the
# variance asked for.
_TRUNC_STD = 0.87962566103423978
_NORMS = (nn.BatchNorm1d, nn.BatchNorm2d, nn.GroupNorm, nn.LayerNorm)


def he_normal_fan_out_(weight: torch.Tensor, gen: torch.Generator) -> None:
    """He-normal, fan_out, ReLU gain: N(0, 2 / fan_out), untruncated."""
    nn.init.kaiming_normal_(weight, mode="fan_out", nonlinearity="relu", generator=gen)


def head_init_(weight: torch.Tensor, gen: torch.Generator) -> None:
    """Final-classifier init N(0, 1/√fan_in) (weight is (out, in))."""
    with torch.no_grad():
        weight.normal_(0.0, 1.0 / math.sqrt(weight.shape[1]), generator=gen)


def lecun_normal_(weight: torch.Tensor, gen: torch.Generator) -> None:
    """Flax's default kernel init: variance 1 / fan_in, truncated at 2σ
    (fan_in = in · kh · kw of an (out, in, kh, kw) or (out, in) weight)."""
    std = math.sqrt(1.0 / weight[0].numel()) / _TRUNC_STD
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=gen)


@torch.no_grad()
def init_like_flax(model: nn.Module, gen: torch.Generator,
                   heads: Sequence[str] = ("fc3",)) -> None:
    """Flax's default init over every submodule, in ``named_modules``
    order: lecun-normal (truncated) conv and linear weights, xavier-uniform
    for the modules named in ``heads``, zero biases, unit norm scales."""
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            if name in heads:
                nn.init.xavier_uniform_(mod.weight, generator=gen)
            else:
                lecun_normal_(mod.weight, gen)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, _NORMS):
            mod.reset_parameters()


class BatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` that takes a training batch of one row as the
    JAX package does: the output is ``bias``, the running mean moves
    towards the row and the running variance decays towards 0."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and x.dim() == 2 and x.shape[0] == 1):
            return super().forward(x)
        xc = x - x.mean(dim=0, keepdim=True)
        var = (xc * xc).mean(dim=0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * x[0])
            self.running_var.mul_(1.0 - m).add_(m * var)  # n / max(n − 1, 1) = 1
            self.num_batches_tracked.add_(1)
        return xc / torch.sqrt(var + self.eps) * self.weight + self.bias


class ConvBNReLU(nn.Module):
    """Conv (no bias) → BatchNorm → ReLU with ``_pre``/``_post`` taps. A
    frozen layer's BatchNorm stays in eval mode (see ``CustomCNN.train``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, frozen_bn: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-5, momentum=0.1)
        self.frozen_bn = frozen_bn

    def forward(self, x: torch.Tensor, name: str, tap: TapFn) -> torch.Tensor:
        x = self.conv(x)
        tap(f"{name}_pre", x)
        x = F.relu(self.bn(x))
        tap(f"{name}_post", x)
        return x


class DenseBNReLU(nn.Module):
    """Linear (with bias) → BatchNorm1d → ReLU with ``_pre``/``_post`` taps."""

    def __init__(self, in_features: int, out_features: int, frozen_bn: bool = False):
        super().__init__()
        self.fc = nn.Linear(in_features, out_features)
        self.bn = BatchNorm1d(out_features, eps=1e-5, momentum=0.1)
        self.frozen_bn = frozen_bn

    def forward(self, x: torch.Tensor, name: str, tap: TapFn) -> torch.Tensor:
        x = self.fc(x)
        tap(f"{name}_pre", x)
        x = F.relu(self.bn(x))
        tap(f"{name}_post", x)
        return x


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator | None) -> torch.Tensor:
    """Flax's dropout with the mask drawn from ``gen``: keep each element
    with probability 1 − rate and scale kept ones by 1 / (1 − rate)."""
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    if gen is None:
        raise ValueError("training-mode dropout needs a torch.Generator (generator=...)")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device, dtype=x.dtype) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
