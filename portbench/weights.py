"""The benchmark's weights and the plain forward the reference taps.

A model's layout is a file of its own, ``models/<model>.py`` (found by
the configuration's ``model`` key), with torchvision's module names,
shapes and forward, so that a state dict made here has the real
torchvision file's keys and the port imports it through its torchvision
path (``pretrained_dataset=imagenet1k`` with ``TORCH_WEIGHTS_DIR``).

Frozen from ``visreps_tpu_torch/benchmarks/weights.py`` (the layouts and
the distributions of its ``seed_weights_``), with one change to the draw:
every parameter comes from ONE ``torch.Generator`` on the run's device,
in one ``randn`` call over all parameters, so that weights are made on
the card from the seed in a fraction of a second (weights N(0, 2 /
fan_in), biases N(0, 0.1²)).

``plain_taps`` runs the forward of a features → pool → classifier layout
and returns the named activations the port's extractor taps
(``conv{i}_pre`` / ``_post``, ``fc{i}_pre`` / ``_post``, ``fc3``), in the
port's flattening: a conv tap in (H, W, C) order.
"""
from __future__ import annotations

import math
import os
from pathlib import Path

import torch
from torch import nn


class FeaturesClassifier(nn.Module):
    """features → adaptive average pool → flatten → classifier."""

    def __init__(self, features: nn.Sequential, grid: int, classifier: nn.Sequential):
        super().__init__()
        self.features = features
        self.avgpool = nn.AdaptiveAvgPool2d((grid, grid))
        self.classifier = classifier

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(torch.flatten(self.avgpool(self.features(x)), 1))


@torch.no_grad()
def seeded(build, seed: int, device) -> nn.Module:
    """``build()``'s layout on ``device`` in eval mode, every parameter
    drawn from ``torch.Generator(device).manual_seed(seed)`` in one call."""
    with torch.device("meta"):
        module = build()
    module = module.to_empty(device=device)
    params = list(module.named_parameters())
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(sum(p.numel() for _, p in params), generator=gen, device=device)
    off = 0
    for name, p in params:
        values = draw[off:off + p.numel()].view_as(p)
        off += p.numel()
        if p.dim() >= 2:
            p.copy_(values * math.sqrt(2.0 / p[0].numel()))
        else:
            p.copy_(values * 0.1)
    return module.eval()


def write_state_dict(path: Path, module: nn.Module) -> Path:
    """Save ``module``'s state dict (on the CPU) at ``path`` and flush it
    to the disk, so that its write-back does not fall into a later
    measurement."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()}, f)
        f.flush()
        os.fsync(f.fileno())
    return path


def torchvision_overrides(cell: dict) -> dict:
    """The eval's model keys for a torchvision layout imported from a
    weight file."""
    return {"load_model_from": "torchvision", "model_name": cell["model_name"],
            "pretrained_dataset": "imagenet1k"}


def install_torchvision(build, cell: dict, seed: int, device, work: Path) -> dict:
    """Write ``seed``'s weights as the torchvision file the port imports;
    returns the environment that points the port at it."""
    module = seeded(build, seed, device)
    write_state_dict(work / "weights" / cell["weights_file"], module)
    del module
    return {"TORCH_WEIGHTS_DIR": str(work / "weights")}


def _plain_tap_names(module: nn.Module) -> list[tuple[nn.Module, str]]:
    """(submodule, tap name) in forward order: a conv or linear layer is
    ``<layer>_pre``, the ReLU after it ``<layer>_post``; the head ``fc3``."""
    out, conv, fc, last = [], 0, 0, None
    for m in list(module.features) + list(module.classifier):
        if isinstance(m, nn.Conv2d):
            conv += 1
            last = f"conv{conv}"
            out.append((m, f"{last}_pre"))
        elif isinstance(m, nn.Linear):
            fc += 1
            last = f"fc{fc}"
            out.append((m, "fc3" if fc == 3 else f"{last}_pre"))
        elif isinstance(m, nn.ReLU):
            out.append((m, f"{last}_post"))
    return out


def _flatten_hwc(t: torch.Tensor) -> torch.Tensor:
    if t.dim() == 4:
        t = t.permute(0, 2, 3, 1)
    return t.reshape(t.shape[0], -1)


@torch.inference_mode()
def plain_taps(module: nn.Module, x: torch.Tensor, names) -> dict[str, torch.Tensor]:
    """{tap: (B, D) activations} of ``names`` for the (B, 3, H, W) batch
    ``x`` through a ``FeaturesClassifier``; the forward stops after the
    last tap asked for."""
    want = set(names)
    name_of = {id(m): name for m, name in _plain_tap_names(module)}
    found: dict[str, torch.Tensor] = {}
    layers = list(module.features) + [module.avgpool, nn.Flatten(1)] + list(module.classifier)
    for m in layers:
        x = m(x)
        name = name_of.get(id(m))
        if name in want:
            found[name] = _flatten_hwc(x)
            if len(found) == len(want):
                break
    return {n: found[n] for n in names}
