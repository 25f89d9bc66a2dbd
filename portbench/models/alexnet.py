"""torchvision AlexNet (Krizhevsky 2014, "One weird trick"), the layout
of ``torchvision.models.alexnet``; frozen from
``visreps_tpu_torch/benchmarks/weights.py``.

A model file gives ``build()`` (the layout), ``taps(module, x, names)``
(the reference's forward), ``overrides(cell)`` (the eval's model keys)
and ``install(cell, seed, device, work)`` (the seed's weights where the
port loads them from; returns the environment that points it there).
"""
from __future__ import annotations

from torch import nn

from portbench import weights


def build(num_classes: int = 1000) -> nn.Module:
    features = nn.Sequential(
        nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
        nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
        nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
        nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
        nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(), nn.MaxPool2d(3, 2))
    classifier = nn.Sequential(
        nn.Dropout(), nn.Linear(256 * 6 * 6, 4096), nn.ReLU(),
        nn.Dropout(), nn.Linear(4096, 4096), nn.ReLU(), nn.Linear(4096, num_classes))
    return weights.FeaturesClassifier(features, 6, classifier)


taps = weights.plain_taps
overrides = weights.torchvision_overrides


def install(cell: dict, seed: int, device, work) -> dict:
    return weights.install_torchvision(build, cell, seed, device, work)
