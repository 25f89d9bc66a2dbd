"""Synthetic weight files in the layouts the port imports, drawn from a
seed: torchvision's IMAGENET1K state dicts (AlexNet, VGG16, ResNet18/50,
ViT-B/16) and the reference's whole-module CustomCNN checkpoints.

The modules below are plain ``torch.nn`` with torchvision's (and the
reference CustomCNN's) module names, shapes and forward, so a file
written from them has the real file's keys, and their forward is an
independent check of an import. Nothing is downloaded: real weight
files go under ``$TORCH_WEIGHTS_DIR`` with torchvision's file names
(``models/torch_import._WEIGHT_FILES``).
"""
from __future__ import annotations

import math
import sys
import types
from collections import OrderedDict
from pathlib import Path
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class _FeaturesClassifier(nn.Module):
    """features → adaptive average pool → flatten → classifier."""

    def __init__(self, features: nn.Sequential, grid: int, classifier: nn.Sequential):
        super().__init__()
        self.features = features
        self.avgpool = nn.AdaptiveAvgPool2d((grid, grid))
        self.classifier = classifier

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(torch.flatten(self.avgpool(self.features(x)), 1))


def torchvision_alexnet(num_classes: int = 1000) -> nn.Module:
    features = nn.Sequential(
        nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
        nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
        nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
        nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
        nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(), nn.MaxPool2d(3, 2))
    classifier = nn.Sequential(
        nn.Dropout(), nn.Linear(256 * 6 * 6, 4096), nn.ReLU(),
        nn.Dropout(), nn.Linear(4096, 4096), nn.ReLU(), nn.Linear(4096, num_classes))
    return _FeaturesClassifier(features, 6, classifier)


def torchvision_vgg16(num_classes: int = 1000) -> nn.Module:
    layers, in_ch = [], 3
    for block in ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512)):
        for out_ch in block:
            layers += [nn.Conv2d(in_ch, out_ch, 3, padding=1), nn.ReLU()]
            in_ch = out_ch
        layers.append(nn.MaxPool2d(2, 2))
    classifier = nn.Sequential(
        nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(),
        nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(), nn.Linear(4096, num_classes))
    return _FeaturesClassifier(nn.Sequential(*layers), 7, classifier)


class _Block(nn.Module):
    """torchvision's BasicBlock (``bottleneck=False``) or Bottleneck."""

    def __init__(self, in_ch: int, width: int, stride: int, bottleneck: bool):
        super().__init__()
        out = width * (4 if bottleneck else 1)
        if bottleneck:
            convs = [(in_ch, width, 1, 1), (width, width, 3, stride), (width, out, 1, 1)]
        else:
            convs = [(in_ch, width, 3, stride), (width, width, 3, 1)]
        self.n = len(convs)
        for i, (cin, cout, k, s) in enumerate(convs, start=1):
            self.add_module(f"conv{i}", nn.Conv2d(cin, cout, k, s, k // 2, bias=False))
            self.add_module(f"bn{i}", nn.BatchNorm2d(cout))
        self.downsample = None
        if stride != 1 or in_ch != out:
            self.downsample = nn.Sequential(nn.Conv2d(in_ch, out, 1, stride, bias=False),
                                            nn.BatchNorm2d(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for i in range(1, self.n + 1):
            y = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(y))
            if i < self.n:
                y = F.relu(y)
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class _ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], bottleneck: bool, num_classes: int):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        in_ch = 64
        for s, (n, width) in enumerate(zip(stage_sizes, (64, 128, 256, 512)), start=1):
            blocks = []
            for b in range(n):
                blocks.append(_Block(in_ch, width, 2 if s > 1 and b == 0 else 1, bottleneck))
                in_ch = width * (4 if bottleneck else 1)
            self.add_module(f"layer{s}", nn.Sequential(*blocks))
        self.fc = nn.Linear(in_ch, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for s in range(1, 5):
            x = getattr(self, f"layer{s}")(x)
        return self.fc(x.mean(dim=(2, 3)))


def torchvision_resnet(stage_sizes: Sequence[int] = (2, 2, 2, 2), bottleneck: bool = False,
                       num_classes: int = 1000) -> nn.Module:
    return _ResNet(stage_sizes, bottleneck, num_classes)


class _EncoderLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(hidden, eps=1e-6)
        self.self_attention = nn.MultiheadAttention(hidden, heads, batch_first=True)
        self.ln_2 = nn.LayerNorm(hidden, eps=1e-6)
        self.mlp = nn.Sequential(nn.Linear(hidden, mlp), nn.GELU(), nn.Dropout(0.0),
                                 nn.Linear(mlp, hidden), nn.Dropout(0.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ln_1(x)
        x = x + self.self_attention(y, y, y, need_weights=False)[0]
        return x + self.mlp(self.ln_2(x))


class _Encoder(nn.Module):
    def __init__(self, n_tokens: int, hidden: int, layers: int, heads: int, mlp: int):
        super().__init__()
        self.pos_embedding = nn.Parameter(torch.zeros(1, n_tokens, hidden))
        self.layers = nn.Sequential(OrderedDict(
            (f"encoder_layer_{i}", _EncoderLayer(hidden, heads, mlp)) for i in range(layers)))
        self.ln = nn.LayerNorm(hidden, eps=1e-6)


class _ViT(nn.Module):
    def __init__(self, num_classes: int, image_size: int, patch: int, hidden: int,
                 layers: int, heads: int, mlp: int):
        super().__init__()
        self.conv_proj = nn.Conv2d(3, hidden, patch, patch)
        self.class_token = nn.Parameter(torch.zeros(1, 1, hidden))
        self.encoder = _Encoder((image_size // patch) ** 2 + 1, hidden, layers, heads, mlp)
        self.heads = nn.Sequential(OrderedDict(head=nn.Linear(hidden, num_classes)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_proj(x).flatten(2).transpose(1, 2)
        x = torch.cat([self.class_token.expand(x.shape[0], -1, -1), x], dim=1)
        x = self.encoder.layers(x + self.encoder.pos_embedding)
        return self.heads(self.encoder.ln(x)[:, 0])


def torchvision_vit(num_classes: int = 1000, image_size: int = 224, patch: int = 16,
                    hidden: int = 768, layers: int = 12, heads: int = 12,
                    mlp: int = 3072) -> nn.Module:
    return _ViT(num_classes, image_size, patch, hidden, layers, heads, mlp)


#: torchvision's full-size layout of each family the port imports.
TORCHVISION_LAYOUTS = {
    "AlexNet": torchvision_alexnet,
    "VGG16": torchvision_vgg16,
    "ResNet18": lambda num_classes=1000: torchvision_resnet((2, 2, 2, 2), False, num_classes),
    "ResNet50": lambda num_classes=1000: torchvision_resnet((3, 4, 6, 3), True, num_classes),
    "ViTBase": torchvision_vit,
}


@torch.no_grad()
def seed_weights_(module: nn.Module, seed: int) -> nn.Module:
    """Redraw every parameter and BatchNorm statistic from
    ``torch.Generator().manual_seed(seed)``: weights N(0, 2 / fan_in),
    norm scales N(1, 0.1²), biases N(0, 0.1²), running means N(0, 0.1²),
    running variances U(0.5, 1.5)."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        if p.dim() >= 2:
            p.normal_(0.0, math.sqrt(2.0 / p[0].numel()), generator=gen)
        else:
            p.normal_(1.0 if name.endswith("weight") else 0.0, 0.1, generator=gen)
    for name, b in module.named_buffers():
        if name.endswith("running_mean"):
            b.normal_(0.0, 0.1, generator=gen)
        elif name.endswith("running_var"):
            b.uniform_(0.5, 1.5, generator=gen)
        else:
            b.zero_()  # num_batches_tracked
    return module.eval()


def seeded(layout, seed: int, *args) -> nn.Module:
    """``layout(*args)`` with every value drawn by ``seed_weights_``,
    allocated without the constructor's own init."""
    with torch.device("meta"):
        module = layout(*args)
    return seed_weights_(module.to_empty(device="cpu"), seed)


def write_torchvision_weights(directory: str | Path, model_name: str, seed: int = 0) -> Path:
    """A seeded state dict in torchvision's layout for ``model_name``,
    saved under torchvision's file name in ``directory``; returns the path."""
    from visreps_tpu_torch.models.torch_import import _WEIGHT_FILES

    path = Path(directory) / _WEIGHT_FILES[model_name]
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(seeded(TORCHVISION_LAYOUTS[model_name], seed).state_dict(), path)
    return path


class ReferenceCustomCNN(nn.Module):
    """The reference's CustomCNN (``visreps/models/custom_model.py``):
    conv → BN → ReLU blocks in ``features``, a 3 × 3 adaptive pool, and
    dropout → linear → BN1d → ReLU twice, then the head, in ``classifier``."""

    def __init__(self, num_classes: int = 1000):
        super().__init__()
        layers, in_ch = [], 3
        for out_ch, k, s, p, pool in ((96, 11, 4, 2, True), (256, 5, 1, 2, True),
                                      (384, 3, 1, 1, False), (384, 3, 1, 1, False),
                                      (256, 3, 1, 1, True)):
            layers += [nn.Conv2d(in_ch, out_ch, k, s, p, bias=False), nn.BatchNorm2d(out_ch),
                       nn.ReLU()]
            if pool:
                layers.append(nn.MaxPool2d(3, 2))
            in_ch = out_ch
        self.features = nn.Sequential(*layers)
        self.adaptive_pool = nn.AdaptiveAvgPool2d((3, 3))
        self.classifier = nn.Sequential(
            nn.Dropout(0.5), nn.Linear(256 * 9, 4096), nn.BatchNorm1d(4096), nn.ReLU(),
            nn.Dropout(0.5), nn.Linear(4096, 4096), nn.BatchNorm1d(4096), nn.ReLU(),
            nn.Linear(4096, num_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(torch.flatten(self.adaptive_pool(self.features(x)), 1))


def write_reference_checkpoint(path: str | Path, num_classes: int = 1000, seed: int = 0,
                               epoch: int = 20, config: dict | None = None) -> nn.Module:
    """A seeded ``ReferenceCustomCNN`` saved as the reference saves its
    checkpoints: ``torch.save({"epoch", "model", "metrics", "config"})``
    with the whole module pickled as
    ``visreps.models.custom_model.CustomCNN`` (a torch zip file). The
    class is registered under that path only while saving. Returns the
    module."""
    model = seeded(ReferenceCustomCNN, seed, num_classes)
    qualname = "visreps.models.custom_model"
    cls = type("CustomCNN", (ReferenceCustomCNN,), {"__module__": qualname})
    added = [n for n in ("visreps", "visreps.models", qualname) if n not in sys.modules]
    for name in added:
        sys.modules[name] = types.ModuleType(name)
    holder = sys.modules[qualname]
    previous = holder.__dict__.get("CustomCNN")
    holder.CustomCNN = cls
    model.__class__ = cls
    try:
        torch.save({"epoch": epoch, "model": model, "metrics": {}, "config": config}, path)
    finally:
        model.__class__ = ReferenceCustomCNN
        if previous is None:
            del holder.CustomCNN
        else:
            holder.CustomCNN = previous
        for name in added:
            del sys.modules[name]
    return model
