"""Batch augmentation on the device: flip and a small rotation (port of
``visreps_tpu/data/augment.py:18-53``).

Each image is flipped left-right with p = 0.5 and rotated by
uniform(−max_degrees, max_degrees)° about its centre with a
nearest-neighbour gather (PIL's default NEAREST resample); pixels that
come from outside the image are 0. ``augment_params`` draws the flips and
angles from an explicit ``torch.Generator``; ``apply_augment`` applies
given ones, so a test can pass in the JAX package's draws.
"""
from __future__ import annotations

import math

import torch


def augment_params(gen: torch.Generator, batch: int, max_degrees: float = 10.0):
    """(flip (B,) bool, angles (B,) float32 degrees) drawn from ``gen``,
    on the generator's device."""
    flip = torch.rand(batch, generator=gen, device=gen.device) < 0.5
    angles = (torch.rand(batch, generator=gen, device=gen.device) * 2.0 - 1.0) * max_degrees
    return flip, angles


def apply_augment(images: torch.Tensor, flip: torch.Tensor, angles: torch.Tensor,
                  channels_last: bool = False) -> torch.Tensor:
    """Flip, then rotate by ``angles`` degrees: images (B, C, H, W), or
    (B, H, W, C) with ``channels_last``."""
    if channels_last:
        b, h, w, c = images.shape
        images = torch.where(flip[:, None, None, None], images.flip(2), images)
    else:
        b, c, h, w = images.shape
        images = torch.where(flip[:, None, None, None], images.flip(3), images)
    rad = angles.to(torch.float32) * (math.pi / 180.0)
    cos, sin = torch.cos(rad)[:, None, None], torch.sin(rad)[:, None, None]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys = torch.arange(h, dtype=torch.float32, device=images.device) - cy
    xs = torch.arange(w, dtype=torch.float32, device=images.device) - cx
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    # inverse rotation: source = R(−θ) · destination
    iy = torch.round(cos * yy + sin * xx + cy).to(torch.int64)
    ix = torch.round(-sin * yy + cos * xx + cx).to(torch.int64)
    valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    src = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(b, h * w)
    if channels_last:
        out = images.reshape(b, h * w, c).gather(1, src[:, :, None].expand(b, h * w, c))
        return torch.where(valid[..., None], out.reshape(b, h, w, c), 0.0)
    out = images.reshape(b, c, h * w).gather(2, src[:, None, :].expand(b, c, h * w))
    return torch.where(valid[:, None], out.reshape(b, c, h, w), 0.0)


def augment_batch(images: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Random flip + rotation of an NCHW batch, drawn from ``gen`` (on
    the batch's device)."""
    flip, angles = augment_params(gen, images.shape[0])
    return apply_augment(images, flip, angles)
