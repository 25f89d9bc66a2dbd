"""Factories for normalisation, nonlinearity, pooling and initialisers
(port of ``visreps_tpu/models/nn_ops.py:15-68``).

Each returns the torch counterpart of the JAX package's choice, with
Flax's defaults where they differ from torch's: GroupNorm and LayerNorm
eps 1e-6, ``gelu`` the tanh approximation (``flax.linen.gelu``), and
``uniform`` drawing from [0, 0.02). Norms act on NCHW maps (channels on
axis 1) or (B, C) rows; LayerNorm normalises the channels of each
position, as Flax's does on the last axis of an NHWC map.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from visreps_tpu_torch.models.layers import BatchNorm2d, he_normal_fan_out_


class ChannelLayerNorm(nn.LayerNorm):
    """LayerNorm over the channel axis of (B, C, H, W) maps (over the
    last axis of (B, C) rows)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__(channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 4:
            return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return super().forward(x)


def get_normalization(norm_type: str, features: int) -> nn.Module:
    """A norm module by name: batch, instance (one group per channel),
    layer or none. The module's train/eval mode decides BatchNorm's
    statistics, as ``train`` does in the JAX package."""
    norm_type = (norm_type or "none").lower()
    if norm_type in ("batch", "batchnorm"):
        return BatchNorm2d(features, eps=1e-5, momentum=0.1)
    if norm_type in ("instance", "instancenorm"):
        return nn.GroupNorm(features, features, eps=1e-6)
    if norm_type in ("layer", "layernorm"):
        return ChannelLayerNorm(features)
    if norm_type == "none":
        return nn.Identity()
    raise ValueError(f"Unknown normalization: {norm_type}")


_NONLINEARITIES = {
    "relu": F.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "elu": F.elu,
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "none": lambda x: x,
}


def get_nonlinearity(name: str):
    name = (name or "relu").lower()
    if name not in _NONLINEARITIES:
        raise ValueError(f"Unknown nonlinearity: {name}")
    return _NONLINEARITIES[name]


def get_pooling_fn(name: str, window: int = 3, stride: int = 2):
    """VALID max or average pooling over NCHW maps, or a global average
    (``adaptive``: (B, C, 1, 1))."""
    name = (name or "max").lower()
    if name == "max":
        return lambda x: F.max_pool2d(x, window, stride)
    if name in ("avg", "average"):
        return lambda x: F.avg_pool2d(x, window, stride)
    if name == "adaptive":
        return lambda x: F.adaptive_avg_pool2d(x, 1)
    raise ValueError(f"Unknown pooling: {name}")


def _normal_002(weight: torch.Tensor, gen: torch.Generator) -> None:
    with torch.no_grad():
        weight.normal_(0.0, 0.02, generator=gen)


def _uniform_002(weight: torch.Tensor, gen: torch.Generator) -> None:
    with torch.no_grad():
        weight.uniform_(0.0, 0.02, generator=gen)


_INITIALIZERS = {
    "xavier": lambda w, gen: nn.init.xavier_uniform_(w, generator=gen),
    "kaiming": he_normal_fan_out_,
    "gaussian": _normal_002,
    "uniform": _uniform_002,
}


def get_initializer(name: str):
    """An in-place initialiser ``fn(weight, generator)`` by name."""
    name = (name or "kaiming").lower()
    if name not in _INITIALIZERS:
        raise ValueError(f"Unknown initializer: {name}")
    return _INITIALIZERS[name]
