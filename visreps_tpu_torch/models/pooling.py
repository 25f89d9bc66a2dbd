"""Pooled multi-layer feature extraction (port of
``visreps_tpu/models/pooling.py``): post-ReLU taps, conv taps adaptively
average-pooled on the device, optional L2 row normalisation."""
from __future__ import annotations

import torch
from torch import nn

from visreps_tpu_torch.models.extractor import _flatten_hwc


def adaptive_avg_pool(x: torch.Tensor, out_hw: int) -> torch.Tensor:
    """NCHW adaptive average pool to (out_hw, out_hw), with the JAX
    package's (and ``nn.AdaptiveAvgPool2d``'s) bins: floor start, ceil
    end."""
    h, w = x.shape[-2:]
    rows = []
    for i in range(out_hw):
        h0, h1 = (i * h) // out_hw, -(-((i + 1) * h) // out_hw)
        rows.append(torch.stack([
            x[..., h0:h1, (j * w) // out_hw:-(-((j + 1) * w) // out_hw)].mean(dim=(-2, -1))
            for j in range(out_hw)], dim=-1))  # (n, c, out_hw)
    return torch.stack(rows, dim=-2)  # (n, c, out_hw, out_hw)


def make_pooled_extractor(model: nn.Module, layers, pool_size: int | None = 3,
                          l2_normalize: bool = True):
    """fn(batch) → {layer: (B, d) float32}: each layer's ``{layer}_post``
    tap, a conv tap pooled to pool_size² (flattened in (H, W, C) order),
    rows optionally L2-normalised (norm floored at 1e-8). ``batch`` is a
    (B, 3, H, W) float32 tensor on the model's device."""
    layers = list(layers)
    points = tuple(f"{layer}_post" for layer in layers)

    @torch.inference_mode()
    def step(x: torch.Tensor) -> dict:
        _, taps = model(x, capture=points)
        out = {}
        for layer, point in zip(layers, points):
            t = taps[point]
            if t.dim() == 4 and pool_size is not None:
                t = adaptive_avg_pool(t, pool_size)
            t = _flatten_hwc(t).to(torch.float32)
            if l2_normalize:
                t = t / t.norm(dim=1, keepdim=True).clamp_min(1e-8)
            out[layer] = t
        return out

    return step
