"""CustomCNN / TinyCustomCNN, the paper's model family (port of
``visreps_tpu/models/custom_cnn.py:41-149``).

Five ConvBNReLU blocks and two DenseBNReLU blocks (BatchNorm everywhere,
max or average pooling, dropout before fc1 and fc2), an adaptive average
pool to 3×3 (4×4 for Tiny), a channel-major flatten (torch's NCHW
flatten, the order the JAX package transposes to) and a linear head.
Per-layer trainability comes from the ``conv_trainable`` / ``fc_trainable``
strings: a frozen layer's BatchNorm stays in eval mode even inside
``model.train()``, and the optimizer leaves its parameters out
(``train/optim.py``). Parameter names follow the Flax modules
(``conv1.conv.weight``, ``conv1.bn.weight``, ``fc1.fc.weight`` …), so
``models/convert.py`` maps them one to one. The forward returns
``(logits, taps)`` like ``AlexNet``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from visreps_tpu_torch.models.layers import (
    ConvBNReLU, DenseBNReLU, dropout, he_normal_fan_out_, head_init_)

CUSTOM_CNN_TAPS = {
    **{f"conv{i}": (f"conv{i}_pre", f"conv{i}_post") for i in range(1, 6)},
    "fc1": ("fc1_pre", "fc1_post"),
    "fc2": ("fc2_pre", "fc2_post"),
    "fc3": ("fc3",),
}


class CustomCNN(nn.Module):
    """AlexNet-style CNN with BatchNorm for 224 × 224 inputs."""

    TAPS = CUSTOM_CNN_TAPS
    INPUT_SIZE = 224
    # (out channels, kernel, stride, padding, pool after)
    CONV_SPECS = [(96, 11, 4, 2, True), (256, 5, 1, 2, True), (384, 3, 1, 1, False),
                  (384, 3, 1, 1, False), (256, 3, 1, 1, True)]
    POOL = 3  # window; stride 2
    GRID = 3  # adaptive average pool output side
    FC = 4096
    DROPOUT = 0.5

    def __init__(self, num_classes: int = 1000, conv_trainable: str = "11111",
                 fc_trainable: str = "111", dropout: float | None = None,
                 pooling_type: str = "max"):
        super().__init__()
        self.num_classes = num_classes
        self.conv_trainable = conv_trainable
        self.fc_trainable = fc_trainable
        self.dropout = self.DROPOUT if dropout is None else dropout
        self.pooling_type = pooling_type
        mask = self.trainable_mask()
        in_ch = 3
        for i, (out_ch, k, s, p, _) in enumerate(self.CONV_SPECS, start=1):
            self.add_module(f"conv{i}", ConvBNReLU(in_ch, out_ch, k, s, p,
                                                   frozen_bn=not mask[f"conv{i}"]))
            in_ch = out_ch
        in_features = in_ch * self.GRID * self.GRID
        for i in (1, 2):
            self.add_module(f"fc{i}", DenseBNReLU(in_features, self.FC,
                                                  frozen_bn=not mask[f"fc{i}"]))
            in_features = self.FC
        self.fc3 = nn.Linear(self.FC, num_classes)

    def spec(self) -> dict:
        """The constructor spec a checkpoint stores (the JAX package's
        ``module_spec``: class name and dataclass fields)."""
        return {"class": type(self).__name__, "num_classes": self.num_classes,
                "conv_trainable": self.conv_trainable, "fc_trainable": self.fc_trainable,
                "dropout": self.dropout, "pooling_type": self.pooling_type}

    def trainable_mask(self) -> dict[str, bool]:
        """{top-level module: trainable} from the mask strings (a string
        shorter than the layer count leaves the rest trainable)."""
        ct, ft = self.conv_trainable, self.fc_trainable
        mask = {f"conv{i}": i > len(ct) or ct[i - 1] == "1" for i in range(1, 6)}
        mask.update({f"fc{i}": i > len(ft) or ft[i - 1] == "1" for i in (1, 2)})
        mask["fc3"] = len(ft) < 3 or ft[2] == "1"
        return mask

    def train(self, mode: bool = True):
        super().train(mode)
        for m in self.modules():
            if isinstance(m, (ConvBNReLU, DenseBNReLU)) and m.frozen_bn:
                m.bn.eval()
        return self

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """The JAX package's init: He-normal fan_out kernels, zero dense
        biases, unit BatchNorm scales, N(0, 1/√fan_in) head."""
        for i in range(1, 6):
            he_normal_fan_out_(getattr(self, f"conv{i}").conv.weight, gen)
        for i in (1, 2):
            fc = getattr(self, f"fc{i}").fc
            he_normal_fan_out_(fc.weight, gen)
            nn.init.zeros_(fc.bias)
        head_init_(self.fc3.weight, gen)
        nn.init.zeros_(self.fc3.bias)
        for m in self.modules():
            if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
                m.reset_parameters()

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        if self.pooling_type == "max":
            return F.max_pool2d(x, self.POOL, stride=2)
        return F.avg_pool2d(x, self.POOL, stride=2)

    def forward(self, x: torch.Tensor, capture: Sequence[str] = (),
                generator: torch.Generator | None = None):
        """x: (B, 3, H, W) → (logits, {tap: tensor}). In training mode
        dropout draws its masks from ``generator``."""
        capture = frozenset(capture)
        taps: dict[str, torch.Tensor] = {}

        def tap(name, value):
            if name in capture:
                taps[name] = value

        for i, (_, _, _, _, pool) in enumerate(self.CONV_SPECS, start=1):
            x = getattr(self, f"conv{i}")(x, f"conv{i}", tap)
            if pool:
                x = self._pool(x)
        x = torch.flatten(F.adaptive_avg_pool2d(x, self.GRID), 1)
        for i in (1, 2):
            if self.training:
                x = dropout(x, self.dropout, generator)
            x = getattr(self, f"fc{i}")(x, f"fc{i}", tap)
        x = self.fc3(x)
        tap("fc3", x)
        return x, taps


class TinyCustomCNN(CustomCNN):
    """CustomCNN's Tiny-ImageNet variant for 64 × 64 inputs."""

    INPUT_SIZE = 64
    CONV_SPECS = [(64, 5, 2, 2, True), (128, 3, 1, 1, False), (256, 3, 1, 1, True),
                  (512, 3, 1, 1, False), (512, 3, 1, 1, False)]
    POOL = 2
    GRID = 4
    FC = 2048
    DROPOUT = 0.3

    def __init__(self, num_classes: int = 200, **kwargs):
        super().__init__(num_classes=num_classes, **kwargs)
