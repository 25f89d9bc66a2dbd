"""AlexNet and VGG16 with named activation taps (port of
``visreps_tpu/models/standard.py:23-119`` and the pools of
``models/layers.py:44-67``).

Same architectures as torchvision's alexnet and vgg16; parameters are
named after the Flax modules (``conv1`` …, ``fc1`` … ``fc3``) so
``models/convert.params_from_jax`` maps them one to one. The forward
runs NCHW (PyTorch's layout) and returns ``(logits, taps)``; each conv
tap is returned NCHW and flattened by the extractor in (H, W, C) order,
the JAX package's NHWC order, so projections see the same feature order.
Each model keeps its own dropout order: AlexNet drops before fc1 and
fc2, VGG16 after their ReLUs.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from visreps_tpu_torch.models.layers import dropout, init_like_flax

ALEXNET_TAPS = {
    **{f"conv{i}": (f"conv{i}_pre", f"conv{i}_post") for i in range(1, 6)},
    "fc1": ("fc1_pre", "fc1_post"),
    "fc2": ("fc2_pre", "fc2_post"),
    "fc3": ("fc3",),
}

# (out_channels, kernel, stride, padding, max-pool after)
_CONV_SPECS = [
    (64, 11, 4, 2, True),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, False),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, True),
]


class AlexNet(nn.Module):
    """torchvision.models.alexnet architecture with tap capture."""

    TAPS = ALEXNET_TAPS

    def __init__(self, num_classes: int = 1000, dropout: float = 0.5):
        super().__init__()
        in_ch = 3
        for i, (out_ch, k, s, p, _) in enumerate(_CONV_SPECS, start=1):
            self.add_module(f"conv{i}", nn.Conv2d(in_ch, out_ch, k, stride=s, padding=p))
            in_ch = out_ch
        self.fc1 = nn.Linear(256 * 6 * 6, 4096)
        self.fc2 = nn.Linear(4096, 4096)
        self.fc3 = nn.Linear(4096, num_classes)
        self.num_classes = num_classes
        self.dropout = dropout

    def spec(self) -> dict:
        """The constructor spec a checkpoint stores (``train/checkpoint.py``)."""
        return {"class": "AlexNet", "num_classes": self.num_classes, "dropout": self.dropout}

    def init_weights(self, gen: torch.Generator) -> None:
        """Flax's default init, xavier-uniform head."""
        init_like_flax(self, gen)

    def forward(self, x: torch.Tensor, capture: Sequence[str] = (),
                generator: torch.Generator | None = None):
        """x: (B, 3, H, W) float → (logits, {tap name: tensor}) for the
        requested tap names. In training mode dropout draws its masks
        from ``generator``."""
        capture = frozenset(capture)
        taps: dict[str, torch.Tensor] = {}

        def tap(name, value):
            if name in capture:
                taps[name] = value

        for i, (_, _, _, _, pool) in enumerate(_CONV_SPECS, start=1):
            x = getattr(self, f"conv{i}")(x)
            tap(f"conv{i}_pre", x)
            x = F.relu(x)
            tap(f"conv{i}_post", x)
            if pool:
                x = F.max_pool2d(x, kernel_size=3, stride=2)
        x = F.adaptive_avg_pool2d(x, (6, 6))
        x = torch.flatten(x, 1)  # channel-major, as the JAX package flattens
        for i in (1, 2):
            if self.training:
                x = dropout(x, self.dropout, generator)
            x = getattr(self, f"fc{i}")(x)
            tap(f"fc{i}_pre", x)
            x = F.relu(x)
            tap(f"fc{i}_post", x)
        x = self.fc3(x)
        tap("fc3", x)
        return x, taps


# (out_channels of each 3×3 conv, 2×2 max-pool after)
_VGG16_PLAN = [
    (64, False), (64, True),
    (128, False), (128, True),
    (256, False), (256, False), (256, True),
    (512, False), (512, False), (512, True),
    (512, False), (512, False), (512, True),
]

VGG16_TAPS = {
    **{f"conv{i}": (f"conv{i}_pre", f"conv{i}_post") for i in range(1, 14)},
    "fc1": ("fc1_pre", "fc1_post"),
    "fc2": ("fc2_pre", "fc2_post"),
    "fc3": ("fc3",),
}


class VGG16(nn.Module):
    """torchvision.models.vgg16 architecture with tap capture."""

    TAPS = VGG16_TAPS

    def __init__(self, num_classes: int = 1000, dropout: float = 0.5):
        super().__init__()
        in_ch = 3
        for i, (out_ch, _) in enumerate(_VGG16_PLAN, start=1):
            self.add_module(f"conv{i}", nn.Conv2d(in_ch, out_ch, 3, padding=1))
            in_ch = out_ch
        self.fc1 = nn.Linear(512 * 7 * 7, 4096)
        self.fc2 = nn.Linear(4096, 4096)
        self.fc3 = nn.Linear(4096, num_classes)
        self.num_classes = num_classes
        self.dropout = dropout

    def spec(self) -> dict:
        return {"class": "VGG16", "num_classes": self.num_classes, "dropout": self.dropout}

    def init_weights(self, gen: torch.Generator) -> None:
        """Flax's default init, xavier-uniform head."""
        init_like_flax(self, gen)

    def forward(self, x: torch.Tensor, capture: Sequence[str] = (),
                generator: torch.Generator | None = None):
        """x: (B, 3, H, W) → (logits, {tap: tensor}); training-mode
        dropout draws from ``generator``."""
        capture = frozenset(capture)
        taps: dict[str, torch.Tensor] = {}

        def tap(name, value):
            if name in capture:
                taps[name] = value

        for i, (_, pool) in enumerate(_VGG16_PLAN, start=1):
            x = getattr(self, f"conv{i}")(x)
            tap(f"conv{i}_pre", x)
            x = F.relu(x)
            tap(f"conv{i}_post", x)
            if pool:
                x = F.max_pool2d(x, 2, 2)
        x = torch.flatten(F.adaptive_avg_pool2d(x, (7, 7)), 1)
        for i in (1, 2):
            x = getattr(self, f"fc{i}")(x)
            tap(f"fc{i}_pre", x)
            x = F.relu(x)
            tap(f"fc{i}_post", x)
            if self.training:
                x = dropout(x, self.dropout, generator)
        x = self.fc3(x)
        tap("fc3", x)
        return x, taps
