"""Z-normalisation with fit-only statistics (port of
``visreps_tpu/ops/znorm.py``): Bessel std (``correction=1``) + 1e-8."""
from __future__ import annotations

import torch


def znorm(x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    return (x - mean) / std


def znorm_fit(x: torch.Tensor):
    """Normalise x with its own column statistics. Returns (normed, mean, std)."""
    mean = x.mean(dim=0)
    std = x.std(dim=0, correction=1) + 1e-8
    return (x - mean) / std, mean, std
