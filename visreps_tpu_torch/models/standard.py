"""AlexNet with named activation taps (port of
``visreps_tpu/models/standard.py:23-69`` and the pools of
``models/layers.py:44-67``).

Same architecture as torchvision's alexnet; parameters are named after
the Flax modules (``conv1`` … ``conv5``, ``fc1`` … ``fc3``) so
``models/convert.params_from_jax`` maps them one to one. The forward
runs NCHW (PyTorch's layout) and returns ``(logits, taps)``; each conv
tap is returned NCHW and flattened by the extractor in (H, W, C) order,
the JAX package's NHWC order, so projections see the same feature order.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

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
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, capture: Sequence[str] = ()):
        """x: (B, 3, H, W) float → (logits, {tap name: tensor}) for the
        requested tap names."""
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
            x = self.dropout(x)
            x = getattr(self, f"fc{i}")(x)
            tap(f"fc{i}_pre", x)
            x = F.relu(x)
            tap(f"fc{i}_post", x)
        x = self.fc3(x)
        tap("fc3", x)
        return x, taps
