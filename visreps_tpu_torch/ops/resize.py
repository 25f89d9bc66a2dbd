"""``jax.image.resize`` in torch (port of ``jax/_src/image/scale.py``'s
``resize``), for the callers that resize as the JAX package does: the
CLIP extraction's bilinear resize and the corruption suite's zoom,
pixelate and octave-noise resizes.

Linear and cubic resizes are one weight-matrix contraction per resized
axis, the weights built as JAX builds them: sample positions at pixel
centres, a triangle or Keys cubic (a = −0.5) kernel, widened by the
scale when downsampling with ``antialias`` (so downsampling low-passes),
each output's weights normalised over the input pixels they reach.
``F.interpolate``'s bilinear clamps at the borders instead, and its
bicubic uses a = −0.75. Nearest takes ``floor((i + 0.5) · in / out)``,
computed in float32 as JAX computes it.
"""
from __future__ import annotations

import torch

_METHODS = {"nearest": "nearest", "linear": "linear", "bilinear": "linear",
            "trilinear": "linear", "triangle": "linear", "cubic": "cubic",
            "bicubic": "cubic", "tricubic": "cubic"}


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def weight_matrix(m: int, n: int, method: str, antialias: bool = True,
                  device: str | torch.device = "cpu") -> torch.Tensor:
    """(m, n) float32 weights taking an axis of m samples to n."""
    kernel = _triangle if _METHODS[method] == "linear" else _keys_cubic
    inv_scale = 1.0 / (n / m)
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(m, dtype=torch.float32, device=device)[:, None]).abs()
    w = kernel(x / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def nearest_indices(m: int, n: int, device: str | torch.device = "cpu") -> torch.Tensor:
    offsets = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * m / n
    return torch.floor(offsets).to(torch.long)


def resize(x: torch.Tensor, shape, method: str, antialias: bool = True) -> torch.Tensor:
    """``x`` resized to ``shape`` (every axis; axes of equal size are left
    alone) by ``method``: nearest, linear / bilinear, cubic / bicubic.
    Float32 out (integer input is widened), on ``x``'s device."""
    if len(shape) != x.dim():
        raise ValueError(f"shape {tuple(shape)} must have one entry per axis of {tuple(x.shape)}")
    if method not in _METHODS:
        raise ValueError(f"unknown resize method {method!r}")
    if not x.is_floating_point():
        x = x.to(torch.float32)
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m == n:
            continue
        if _METHODS[method] == "nearest":
            x = x.index_select(d, nearest_indices(m, n, x.device))
            continue
        w = weight_matrix(m, n, method, antialias, x.device).to(x.dtype)
        x = torch.movedim(torch.movedim(x, d, -1) @ w, -1, d)
    return x
