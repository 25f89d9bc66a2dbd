"""Model factory (port of ``visreps_tpu/models/zoo.py:27-35, 75-88,
187-284``): AlexNet for ``load_model_from=torchvision`` with
``pretrained_dataset=none``, CustomCNN / TinyCustomCNN for
``model_class=custom_model``, and checkpoints in the JAX package's
format for ``load_model_from=checkpoint``."""
from __future__ import annotations

import math

import torch
from torch import nn

from visreps_tpu_torch.core.config import get_seed_letter
from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.device import resolve_device
from visreps_tpu_torch.models.custom_cnn import CustomCNN, TinyCustomCNN
from visreps_tpu_torch.models.standard import AlexNet

# Default extraction points (reference: visreps/models/utils.py:27-31).
TORCHVISION_RETURN_NODES = {
    "AlexNet": ["conv1", "conv2", "conv3", "conv4", "conv5", "fc1", "fc2"],
}

MODEL_REGISTRY = {"AlexNet": AlexNet, "CustomCNN": CustomCNN, "TinyCustomCNN": TinyCustomCNN}

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


def build_model(model_name: str, num_classes: int, arch=None) -> nn.Module:
    """An uninitialised model; CustomCNN / TinyCustomCNN take the config's
    ``arch`` fields (``zoo.py:75-88`` of the JAX package)."""
    if model_name not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"model {model_name!r} is not ported yet (ROADMAP.md, 'Remaining models')")
    if model_name == "AlexNet":
        return AlexNet(num_classes=num_classes)
    arch = arch or {}
    return MODEL_REGISTRY[model_name](
        num_classes=num_classes,
        conv_trainable=arch.get("conv_trainable", "11111"),
        fc_trainable=arch.get("fc_trainable", "111"),
        dropout=arch.get("dropout"),
        pooling_type=arch.get("pooling_type", "max"))


def init_model(model_name: str = "AlexNet", num_classes: int = 1000, seed: int = 0,
               device: str | torch.device | None = None, arch=None) -> nn.Module:
    """A fresh model in eval mode on ``device`` (CUDA unless ``"cpu"`` is
    asked for), its weights drawn on the CPU from
    ``torch.Generator().manual_seed(seed)`` (so the same seed gives the
    same weights on every device)."""
    model = build_model(model_name, num_classes, arch)
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    if isinstance(model, CustomCNN):
        model.init_weights(gen)
    else:
        _init_like_flax(model, gen)
    return model.to(device).eval()


def checkpoint_path(cfg) -> str:
    """``{checkpoint_dir}/cfg{cfg_id}{seed_letter}/{checkpoint_model}``."""
    return (f"{cfg.checkpoint_dir}/cfg{cfg.cfg_id}{get_seed_letter(cfg.seed)}/"
            f"{cfg.checkpoint_model}")


def load_model(cfg, num_classes: int | None = None,
               device: str | torch.device | None = None) -> nn.Module:
    """The model a config asks for, on ``device`` (CUDA unless ``"cpu"``
    is asked for), in eval mode: a checkpoint (``load_model_from=
    checkpoint``), a fresh CustomCNN / TinyCustomCNN (``model_class=
    custom_model``), or an untrained torchvision-architecture model."""
    if cfg.get("load_model_from") == "checkpoint":
        from visreps_tpu_torch.train.checkpoint import load_checkpoint

        if num_classes is not None:
            rprint("WARNING: num_classes is ignored when loading from checkpoint", style="warning")
        model, _ = load_checkpoint(checkpoint_path(cfg), device=device)
        rprint(f"  Loaded checkpoint (cfg{cfg.cfg_id}{get_seed_letter(cfg.seed)})", style="success")
        return model
    model_name = cfg.get("model_name", "AlexNet")
    if cfg.get("model_class", "standard_model") == "custom_model":
        name = "TinyCustomCNN" if "tiny" in model_name.lower() else "CustomCNN"
        return init_model(name, num_classes or 1000, seed=cfg.get("seed", 0), device=device,
                          arch=cfg.get("arch"))
    if cfg.get("pretrained_dataset", "none") != "none":
        raise NotImplementedError(
            "pretrained weights are not ported yet (ROADMAP.md, 'Remaining models'); "
            "use pretrained_dataset=none")
    return init_model(model_name, num_classes or 1000, seed=cfg.get("seed", 0), device=device)
