"""ResNet-18 / ResNet-50 with named activation taps (port of
``visreps_tpu/models/resnet.py:18-109``), torchvision-equivalent.

Taps as the reference's FeatureExtractor places them: ``conv1`` is the
raw stem convolution (before BatchNorm), ``block{i}`` each residual
block's post-ReLU output, ``fc1`` the logits. BatchNorm is
``nn.BatchNorm2d`` (momentum 0.1, eps 1e-5: the JAX package's
``TorchBatchNorm``). Modules are named after the Flax ones
(``layer{s}_{b}.conv1``, ``…downsample_conv``, ``…downsample_bn``), so
``models/convert.params_from_jax`` maps them one to one.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from visreps_tpu_torch.models.layers import init_like_flax


def _bn(features: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, features, 3, stride=stride, padding=1, bias=False)
        self.bn1 = _bn(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = _bn(features)
        self.downsample_conv = self.downsample_bn = None
        if stride != 1 or in_ch != features:
            self.downsample_conv = nn.Conv2d(in_ch, features, 1, stride=stride, bias=False)
            self.downsample_bn = _bn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample_conv is not None:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + x)


class Bottleneck(nn.Module):
    """1×1 → 3×3 (stride) → 1×1 to 4 × ``features`` channels."""

    expansion = 4

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        out = features * 4
        self.conv1 = nn.Conv2d(in_ch, features, 1, bias=False)
        self.bn1 = _bn(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride=stride, padding=1, bias=False)
        self.bn2 = _bn(features)
        self.conv3 = nn.Conv2d(features, out, 1, bias=False)
        self.bn3 = _bn(out)
        self.downsample_conv = self.downsample_bn = None
        if stride != 1 or in_ch != out:
            self.downsample_conv = nn.Conv2d(in_ch, out, 1, stride=stride, bias=False)
            self.downsample_bn = _bn(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample_conv is not None:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + x)


_BLOCKS = {"BasicBlock": BasicBlock, "Bottleneck": Bottleneck}


class ResNet(nn.Module):
    """Stem (7×7/2 conv, BN, ReLU, 3×3/2 max pool) → four stages of
    ``stage_sizes`` blocks at widths 64–512 → global average → fc."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 block_cls: type = BasicBlock, num_classes: int = 1000):
        super().__init__()
        if isinstance(block_cls, str):  # a checkpoint's "__class__:Name"
            block_cls = _BLOCKS[block_cls.split(":")[-1]]
        self.stage_sizes = tuple(stage_sizes)
        self.block_cls = block_cls
        self.num_classes = num_classes
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        in_ch = 64
        for stage, (n, width) in enumerate(zip(self.stage_sizes, (64, 128, 256, 512))):
            for b in range(n):
                stride = 2 if stage > 0 and b == 0 else 1
                self.add_module(f"layer{stage + 1}_{b}", block_cls(in_ch, width, stride))
                in_ch = width * block_cls.expansion
        self.fc = nn.Linear(in_ch, num_classes)
        n_blocks = sum(self.stage_sizes)
        self.TAPS = {"conv1": ("conv1",),
                     **{f"block{i}": (f"block{i}",) for i in range(1, n_blocks + 1)},
                     "fc1": ("fc1",)}

    def spec(self) -> dict:
        """The JAX package's ``module_spec`` of a ResNet."""
        return {"class": "ResNet", "stage_sizes": self.stage_sizes,
                "block_cls": f"__class__:{self.block_cls.__name__}",
                "num_classes": self.num_classes}

    def init_weights(self, gen: torch.Generator) -> None:
        """Flax's default init (lecun-normal convs), xavier-uniform fc."""
        init_like_flax(self, gen, heads=("fc",))

    def forward(self, x: torch.Tensor, capture: Sequence[str] = (),
                generator: torch.Generator | None = None):
        """x: (B, 3, H, W) → (logits, {tap: tensor})."""
        capture = frozenset(capture)
        taps: dict[str, torch.Tensor] = {}

        def tap(name, value):
            if name in capture:
                taps[name] = value

        x = self.conv1(x)
        tap("conv1", x)
        x = F.max_pool2d(F.relu(self.bn1(x)), 3, 2, padding=1)  # −inf padding
        block_id = 1
        for stage, n in enumerate(self.stage_sizes):
            for b in range(n):
                x = getattr(self, f"layer{stage + 1}_{b}")(x)
                tap(f"block{block_id}", x)
                block_id += 1
        x = self.fc(x.mean(dim=(2, 3)))
        tap("fc1", x)
        return x, taps


def ResNet18(num_classes: int = 1000) -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlock, num_classes)


def ResNet50(num_classes: int = 1000) -> ResNet:
    return ResNet((3, 4, 6, 3), Bottleneck, num_classes)
