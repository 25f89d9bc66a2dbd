"""Model building blocks with activation taps (port of
``visreps_tpu/models/layers.py:18-67, 70-173``).

``nn.BatchNorm2d/1d`` already have the semantics the JAX package's
``TorchBatchNorm`` copies (momentum 0.1, eps 1e-5, normalise with the
biased batch variance, update the running variance with the unbiased
one). ``BatchNorm2d`` / ``BatchNorm1d`` below add two cases:

  * bfloat16 compute (``train_compute_dtype=bf16``): the input and the
    affine parameters arrive as bf16 while the running statistics stay
    float32, as in the JAX package's bf16 step. ``F.batch_norm`` refuses
    bf16 affine parameters beside f32 statistics ("expected scalar type
    BFloat16 but found Float"), so the bf16 scale and bias are widened to
    f32 (exactly) for the call: statistics and normalisation in f32, the
    output in bf16, the running statistics updated in f32. The JAX
    package rounds the batch mean and variance to bf16 first; the two
    differ by bf16 rounding only.
  * a dense batch of one row in training mode: torch raises, the JAX
    package returns ``bias`` (x − mean = 0) and keeps the update finite
    with ``n / max(n − 1, 1)``;
  * data parallelism (``sync_batch_norm``): in training mode the batch
    statistics are the global batch's, summed over the ranks of a
    process group, as GSPMD computes them over a sharded batch. This is
    ``nn.SyncBatchNorm``'s arithmetic (mean, then the biased variance
    about it, by differentiable all-reduces; the running variance
    unbiased over the global count), kept in these classes because
    ``nn.SyncBatchNorm`` refuses CPU tensors (gloo ranks) and would drop
    the bf16 case above.

Dropout draws its mask for the global batch and keeps this rank's rows
inside ``global_batch_rows``, so data-parallel ranks that share a
generator's state apply the single-process mask.

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
from contextlib import contextmanager
from contextvars import ContextVar
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


class _BatchNorm:
    """Mixin for ``nn.BatchNorm*d``: an input in another dtype than the
    running statistics (bf16 compute) normalises with the affine
    parameters widened to the statistics' dtype, and a module given a
    ``process_group`` normalises a training batch with the global
    batch's statistics; see the module doc."""

    #: Process group whose ranks' batches make up the global batch in
    #: training mode (set by ``sync_batch_norm``); None: this batch alone.
    process_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.process_group is not None:
            return self._global_batch_norm(x)
        if x.dtype == self.running_mean.dtype:
            return super().forward(x)
        self._check_input_dim(x)
        if self.training:
            self.num_batches_tracked.add_(1)
        dtype = self.running_mean.dtype
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight.to(dtype),
                            self.bias.to(dtype), self.training, self.momentum, self.eps)

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Training-mode batch norm over the process group's global batch:
        the sum and count, then the squared deviations about the global
        mean, all-reduced (backward sums the gradients over the ranks)."""
        from torch.distributed.nn.functional import all_reduce

        self._check_input_dim(x)
        dtype = self.running_mean.dtype
        xs = x.to(dtype)
        dims = [0, *range(2, x.dim())]
        shape = [1, -1] + [1] * (x.dim() - 2)
        count = torch.full((1,), float(xs.numel() // xs.shape[1]), dtype=dtype, device=x.device)
        total = all_reduce(torch.cat([xs.sum(dims), count]), group=self.process_group)
        n = total[-1]
        mean = total[:-1] / n
        xc = xs - mean.view(shape)
        var = all_reduce((xc * xc).sum(dims), group=self.process_group) / n
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean)
            self.running_var.mul_(1.0 - m).add_(m * var * n / torch.clamp(n - 1, min=1))
            self.num_batches_tracked.add_(1)
        y = xc * torch.rsqrt(var + self.eps).view(shape)
        y = y * self.weight.to(dtype).view(shape) + self.bias.to(dtype).view(shape)
        return y.to(x.dtype)


def sync_batch_norm(model: nn.Module, group) -> nn.Module:
    """Every BatchNorm of ``model`` normalises training batches with the
    statistics of the global batch over ``group`` (None: its own batch
    again). In place; returns ``model``."""
    for mod in model.modules():
        if isinstance(mod, _BatchNorm):
            mod.process_group = group
    return model


class BatchNorm2d(_BatchNorm, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that also takes bf16 input beside f32 statistics."""


class BatchNorm1d(_BatchNorm, nn.BatchNorm1d):
    """``nn.BatchNorm1d`` that also takes bf16 input beside f32 statistics,
    and a training batch of one row as the JAX package does: the output
    is ``bias``, the running mean moves towards the row and the running
    variance decays towards 0."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # a synced module counts the global batch's rows (every rank takes
        # the global path, whatever its own row count)
        if (not (self.training and x.dim() == 2 and x.shape[0] == 1)
                or self.process_group is not None):
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
        self.bn = BatchNorm2d(out_ch, eps=1e-5, momentum=0.1)
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


_GLOBAL_ROWS: ContextVar = ContextVar("global_rows", default=None)


@contextmanager
def global_batch_rows(offset: int, total: int):
    """Within this block ``dropout`` draws its mask for a global batch of
    ``total`` rows and keeps rows [offset, offset + the input's rows):
    a data-parallel rank's piece of the single-process mask."""
    token = _GLOBAL_ROWS.set((offset, total))
    try:
        yield
    finally:
        _GLOBAL_ROWS.reset(token)


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator | None) -> torch.Tensor:
    """Flax's dropout with the mask drawn from ``gen``: keep each element
    with probability 1 − rate and scale kept ones by 1 / (1 − rate). The
    uniforms are float32 whatever ``x``'s dtype (a bf16 draw would move
    the keep probability by up to 2⁻⁸); inside ``global_batch_rows`` they
    are the global batch's, sliced to this rank's rows."""
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    if gen is None:
        raise ValueError("training-mode dropout needs a torch.Generator (generator=...)")
    keep = 1.0 - rate
    rows = _GLOBAL_ROWS.get()
    if rows is None:
        mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    else:
        offset, total = rows
        mask = torch.rand((total, *x.shape[1:]), generator=gen, device=x.device) < keep
        mask = mask[offset:offset + x.shape[0]]
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
