"""torchvision VGG16 (Simonyan and Zisserman 2014), the layout of
``torchvision.models.vgg16``; frozen from
``visreps_tpu_torch/benchmarks/weights.py``. The file's interface is
``models/alexnet.py``'s."""
from __future__ import annotations

from torch import nn

from portbench import weights


def build(num_classes: int = 1000) -> nn.Module:
    layers, in_ch = [], 3
    for block in ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512)):
        for out_ch in block:
            layers += [nn.Conv2d(in_ch, out_ch, 3, padding=1), nn.ReLU()]
            in_ch = out_ch
        layers.append(nn.MaxPool2d(2, 2))
    classifier = nn.Sequential(
        nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(),
        nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(), nn.Linear(4096, num_classes))
    return weights.FeaturesClassifier(nn.Sequential(*layers), 7, classifier)


taps = weights.plain_taps
overrides = weights.torchvision_overrides


def install(cell: dict, seed: int, device, work) -> dict:
    return weights.install_torchvision(build, cell, seed, device, work)
