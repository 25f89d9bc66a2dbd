"""ImageNet-C-style corruption suite on the device (port of
``experiments/coarse_grain_benefits/corruptions.py``).

Every corruption is a torch function over a batch of float images in
[0, 255], (B, H, W, 3), on the batch's device, with the JAX module's
severity tables and arithmetic: noise, blurs (depthwise ``conv2d`` with
``groups=3``, SAME padding), procedural weather, and the digital ones;
resizes go through ``ops/resize.py`` (``jax.image.resize``'s filters).
``jpeg_compression`` round-trips through PIL's JPEG encoder on the host.

Random draws come from an explicit ``torch.Generator`` on the batch's
device (``corrupt_batch``: seeded with ``seed``). They cannot equal
``jax.random``'s bits, so the random corruptions match the JAX module in
distribution, not value; brightness, contrast, pixelate, defocus blur,
zoom blur and jpeg draw nothing and match it in value.
"""
from __future__ import annotations

import io
import math

import numpy as np
import torch
import torch.nn.functional as F

from visreps_tpu_torch.device import input_device
from visreps_tpu_torch.ops.resize import resize

# Severity constants from the ImageNet-C reference (make_imagenet_c.py).
_GAUSS = [0.04, 0.06, 0.08, 0.09, 0.10]
_SHOT = [500, 250, 100, 75, 50]
_IMPULSE = [0.01, 0.02, 0.03, 0.05, 0.07]
_MOTION = [(10, 3), (15, 5), (15, 8), (15, 12), (20, 15)]  # (kernel, sigma→len)
_ZOOM = [1.06, 1.11, 1.16, 1.21, 1.26]
_BRIGHT = [0.1, 0.2, 0.3, 0.4, 0.5]
_CONTRAST = [0.75, 0.5, 0.4, 0.3, 0.15]
_PIXELATE = [0.6, 0.5, 0.4, 0.3, 0.25]
_GLASS = [(0.05, 1, 1), (0.25, 1, 1), (0.4, 1, 1), (0.25, 1, 2), (0.4, 1, 2)]
_FOG = [(1.5, 2.0), (2.0, 2.0), (2.5, 1.7), (2.5, 1.5), (3.0, 1.4)]
_SNOW = [0.1, 0.2, 0.3, 0.45, 0.55]
_FROST = [0.4, 0.5, 0.6, 0.7, 0.75]


def _level(severity) -> int:
    return int(np.clip(severity, 1, 5))


def _sev(table, severity):
    return table[_level(severity) - 1]


def _clip(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 255.0)


def _uniform(gen, shape, device, low=0.0, high=1.0) -> torch.Tensor:
    return low + (high - low) * torch.rand(shape, generator=gen, device=device)


# ── noise ─────────────────────────────────────────────────────────
def gaussian_noise(gen, x, severity=3):
    c = _sev(_GAUSS, severity)
    return _clip(x + 255.0 * c * torch.randn(x.shape, generator=gen, device=x.device))


def shot_noise(gen, x, severity=3):
    c = _sev(_SHOT, severity)
    lam = torch.clamp(x / 255.0 * c, min=1e-6)
    return _clip(torch.poisson(lam, generator=gen) / c * 255.0)


def impulse_noise(gen, x, severity=3):
    amount = _sev(_IMPULSE, severity)
    u = torch.rand(x.shape, generator=gen, device=x.device)
    salt = torch.rand(x.shape, generator=gen, device=x.device) < 0.5
    return torch.where(u < amount, torch.where(salt, 255.0, 0.0), x)


# ── blurs ─────────────────────────────────────────────────────────
def _gaussian_kernel(sigma: float, radius: int, device) -> torch.Tensor:
    ax = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-(ax ** 2) / (2 * sigma ** 2))
    return k / k.sum()


def _depthwise_blur2d(x: torch.Tensor, kernel2d: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) ⊛ (kh, kw) per channel, SAME padding (odd kernels)."""
    kh, kw = kernel2d.shape
    weight = kernel2d.to(x.dtype).expand(3, 1, kh, kw)
    out = F.conv2d(x.permute(0, 3, 1, 2), weight, padding=(kh // 2, kw // 2), groups=3)
    return out.permute(0, 2, 3, 1)


def _disk_kernel(radius: float, device) -> torch.Tensor:
    r = max(int(np.ceil(radius)), 1)
    ax = torch.arange(-r, r + 1, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")
    disk = (yy ** 2 + xx ** 2 <= radius ** 2 + 1e-6).to(torch.float32)
    return disk / disk.sum()


def defocus_blur(gen, x, severity=3):
    radius, alias = {1: (3, 0.1), 2: (4, 0.5), 3: (6, 0.5), 4: (8, 0.5),
                     5: (10, 0.5)}[_level(severity)]
    out = _depthwise_blur2d(x, _disk_kernel(radius, x.device))
    if alias > 0:
        g = _gaussian_kernel(alias * 4 + 1e-3, 2, x.device)
        out = _depthwise_blur2d(out, torch.outer(g, g))
    return _clip(out)


def _motion_kernel(size: int, length: float, angle: torch.Tensor) -> torch.Tensor:
    r = size // 2
    ax = torch.arange(-r, r + 1, dtype=torch.float32, device=angle.device)
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")
    # soft line of the given length/angle
    d_along = xx * torch.cos(angle) + yy * torch.sin(angle)
    d_perp = -xx * torch.sin(angle) + yy * torch.cos(angle)
    k = ((d_perp.abs() < 0.8) & (d_along.abs() <= length)).to(torch.float32)
    return k / torch.clamp(k.sum(), min=1.0)


def motion_blur(gen, x, severity=3):
    size, length = _sev(_MOTION, severity)
    angle = _uniform(gen, (), x.device, -math.pi / 4, math.pi / 4)
    return _clip(_depthwise_blur2d(x, _motion_kernel(size, length, angle)))


def zoom_blur(gen, x, severity=3):
    c = _sev(_ZOOM, severity)
    h, w = x.shape[1:3]
    acc = x
    n = 1
    for z in np.arange(1.01, c, 0.02):
        zh, zw = int(h / z), int(w / z)
        top, left = (h - zh) // 2, (w - zw) // 2
        crop = x[:, top:top + zh, left:left + zw]
        acc = acc + resize(crop, x.shape, "linear")
        n += 1
    return _clip(acc / n)


def glass_blur(gen, x, severity=3):
    sigma, max_delta, iters = _sev(_GLASS, severity)
    _, h, w, _ = x.shape
    g = _gaussian_kernel(max(sigma * 3, 0.5), 2, x.device)
    out = _depthwise_blur2d(x, torch.outer(g, g))
    yy, xx = torch.meshgrid(torch.arange(h, device=x.device), torch.arange(w, device=x.device),
                            indexing="ij")
    for _ in range(iters):
        dxy = torch.randint(-max_delta, max_delta + 1, (h, w, 2), generator=gen, device=x.device)
        sy = torch.clamp(yy + dxy[..., 0], 0, h - 1)
        sx = torch.clamp(xx + dxy[..., 1], 0, w - 1)
        out = out[:, sy, sx, :]
    return _clip(_depthwise_blur2d(out, torch.outer(g, g)))


# ── weather (procedural) ─────────────────────────────────────────
def _octave_noise(gen, shape_hw, device, octaves=4) -> torch.Tensor:
    """Multi-octave value noise in [0, 1] — plasma-fractal stand-in."""
    h, w = shape_hw
    total = torch.zeros((h, w), device=device)
    amp, norm = 1.0, 0.0
    for o in range(octaves):
        gh, gw = max(2, h >> (octaves - o)), max(2, w >> (octaves - o))
        grid = torch.rand((gh, gw), generator=gen, device=device)
        total = total + amp * resize(grid, (h, w), "bicubic")
        norm += amp
        amp *= 0.5
    t = total / norm
    return (t - t.min()) / (t.max() - t.min() + 1e-8)


def fog(gen, x, severity=3):
    strength, decay = _sev(_FOG, severity)
    noise = _octave_noise(gen, x.shape[1:3], x.device, octaves=5) ** decay
    fog_layer = strength * 255.0 * noise[None, :, :, None]
    max_val = x.amax(dim=(1, 2, 3), keepdim=True)
    out = (x + fog_layer) * max_val / torch.clamp(max_val + strength * 255.0, min=1e-6)
    return _clip(out)


def frost(gen, x, severity=3):
    c = _sev(_FROST, severity)
    crystals = _octave_noise(gen, x.shape[1:3], x.device, octaves=3)
    crystals = torch.where(crystals > 0.6, crystals, 0.0)[None, :, :, None]
    tint = 200.0 + 55.0 * torch.rand((1, 1, 1, 3), generator=gen, device=x.device)
    return _clip((1 - c * crystals) * x + c * crystals * tint)


def snow(gen, x, severity=3):
    c = _sev(_SNOW, severity)
    flakes = (torch.rand(x.shape[:3], generator=gen, device=x.device) < c * 0.02)
    flakes = _depthwise_blur2d(flakes.to(torch.float32)[..., None].repeat(1, 1, 1, 3),
                               _disk_kernel(1.5, x.device))
    streaked = motion_blur(gen, flakes * 255.0 * 8.0, severity=min(severity, 3))
    dimmed = x * (1 - c * 0.4) + c * 0.4 * torch.clamp(x, min=128.0)
    return _clip(dimmed + streaked)


# ── digital ───────────────────────────────────────────────────────
def brightness(gen, x, severity=3):
    return _clip(x + 255.0 * _sev(_BRIGHT, severity))


def contrast(gen, x, severity=3):
    c = _sev(_CONTRAST, severity)
    mean = x.mean(dim=(1, 2), keepdim=True)
    return _clip((x - mean) * c + mean)


def pixelate(gen, x, severity=3):
    c = _sev(_PIXELATE, severity)
    b, h, w, ch = x.shape
    small = resize(x, (b, max(1, int(h * c)), max(1, int(w * c)), ch), "nearest")
    return resize(small, x.shape, "nearest")


def elastic_transform(gen, x, severity=3):
    """Displacement-field warp with a bilinear gather."""
    alpha_frac, sigma_frac = {1: (0.05, 0.01), 2: (0.065, 0.01), 3: (0.085, 0.01),
                              4: (0.11, 0.01), 5: (0.15, 0.01)}[_level(severity)]
    _, h, w, _ = x.shape
    alpha = alpha_frac * h
    sigma = max(sigma_frac * h, 1.0)
    g = _gaussian_kernel(sigma, int(3 * sigma), x.device)
    kern = torch.outer(g, g)

    def smooth(field):
        return _depthwise_blur2d(field[None, :, :, None].repeat(1, 1, 1, 3), kern)[0, :, :, 0]

    dy = smooth(_uniform(gen, (h, w), x.device, -1.0, 1.0)) * alpha
    dx = smooth(_uniform(gen, (h, w), x.device, -1.0, 1.0)) * alpha
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=x.device),
                            torch.arange(w, dtype=torch.float32, device=x.device), indexing="ij")
    sy = torch.clamp(yy + dy, 0, h - 1)
    sx = torch.clamp(xx + dx, 0, w - 1)
    y0, x0 = torch.floor(sy).long(), torch.floor(sx).long()
    y1, x1 = torch.clamp(y0 + 1, 0, h - 1), torch.clamp(x0 + 1, 0, w - 1)
    wy = (sy - y0)[None, :, :, None]
    wx = (sx - x0)[None, :, :, None]
    out = (x[:, y0, x0] * (1 - wy) * (1 - wx) + x[:, y1, x0] * wy * (1 - wx)
           + x[:, y0, x1] * (1 - wy) * wx + x[:, y1, x1] * wy * wx)
    return _clip(out)


def jpeg_compression(gen, x, severity=3):
    """A real JPEG round trip on the host (quality per ImageNet-C)."""
    from PIL import Image

    quality = [25, 18, 15, 10, 7][_level(severity) - 1]
    arr = x.cpu().numpy().astype(np.uint8)
    out = np.empty_like(arr)
    for i in range(arr.shape[0]):
        buf = io.BytesIO()
        Image.fromarray(arr[i]).save(buf, format="JPEG", quality=quality)
        out[i] = np.array(Image.open(buf))
    return torch.from_numpy(out).to(x.device, torch.float32)


CORRUPTIONS = {
    "gaussian_noise": gaussian_noise,
    "shot_noise": shot_noise,
    "impulse_noise": impulse_noise,
    "defocus_blur": defocus_blur,
    "glass_blur": glass_blur,
    "motion_blur": motion_blur,
    "zoom_blur": zoom_blur,
    "snow": snow,
    "frost": frost,
    "fog": fog,
    "brightness": brightness,
    "contrast": contrast,
    "elastic_transform": elastic_transform,
    "pixelate": pixelate,
    "jpeg_compression": jpeg_compression,
}


@torch.no_grad()
def corrupt_batch(name: str, images, severity: int = 3, seed: int = 0,
                  device=None) -> torch.Tensor:
    """One corruption of a uint8 or float (B, H, W, 3) batch (array or
    tensor), as float32 in [0, 255] on ``device`` (default: the
    tensor's), drawing from ``torch.Generator(device).manual_seed(seed)``."""
    device = input_device(images, device)
    x = torch.as_tensor(images).to(device, torch.float32)
    gen = torch.Generator(device=device).manual_seed(seed)
    return _clip(CORRUPTIONS[name](gen, x, severity))
