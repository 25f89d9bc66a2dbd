"""Model factory (port of ``visreps_tpu/models/zoo.py:27-35, 187-284``
for ``load_model_from=torchvision``, ``pretrained_dataset=none``)."""
from __future__ import annotations

import math

import torch
from torch import nn

from visreps_tpu_torch.device import resolve_device
from visreps_tpu_torch.models.standard import AlexNet

# Default extraction points (reference: visreps/models/utils.py:27-31).
TORCHVISION_RETURN_NODES = {
    "AlexNet": ["conv1", "conv2", "conv3", "conv4", "conv5", "fc1", "fc2"],
}

MODEL_REGISTRY = {"AlexNet": AlexNet}

# Flax's truncated-normal initialisers divide the stddev by the std of a
# unit normal truncated to [-2, 2], so the truncated draw keeps the
# variance asked for.
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def _init_like_flax(model: nn.Module, gen: torch.Generator) -> None:
    """The JAX package's init family: lecun-normal (fan_in, truncated)
    kernels and zero biases, xavier-uniform for the final classifier."""
    for name, mod in model.named_children():
        if not isinstance(mod, (nn.Conv2d, nn.Linear)):
            continue
        if name == "fc3":
            nn.init.xavier_uniform_(mod.weight, generator=gen)
        else:
            fan_in = mod.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std, b=2 * std, generator=gen)
        nn.init.zeros_(mod.bias)


def init_model(model_name: str = "AlexNet", num_classes: int = 1000, seed: int = 0,
               device: str | torch.device | None = None) -> nn.Module:
    """A fresh model in eval mode on ``device`` (CUDA unless ``"cpu"`` is
    asked for), its weights drawn on the CPU from
    ``torch.Generator().manual_seed(seed)`` (so the same seed gives the
    same weights on every device)."""
    if model_name not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"model {model_name!r} is not ported yet (ROADMAP.md, 'Remaining models')")
    device = resolve_device(device)
    model = MODEL_REGISTRY[model_name](num_classes=num_classes)
    _init_like_flax(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def load_model(cfg, device: str | torch.device | None = None) -> nn.Module:
    """Untrained torchvision-architecture model for an eval config, on
    ``device`` (CUDA unless ``"cpu"`` is asked for)."""
    if cfg.get("load_model_from") != "torchvision":
        raise NotImplementedError(
            "load_model_from=checkpoint is not ported yet (ROADMAP.md, 'Training')")
    if cfg.get("pretrained_dataset", "none") != "none":
        raise NotImplementedError(
            "pretrained weights are not ported yet (ROADMAP.md, 'Remaining models'); "
            "use pretrained_dataset=none")
    return init_model(cfg.get("model_name", "AlexNet"), 1000,
                      seed=cfg.get("seed", 0), device=device)
