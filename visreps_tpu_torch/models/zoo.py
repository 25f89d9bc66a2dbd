"""Model factory (port of ``visreps_tpu/models/zoo.py:27-46, 75-88,
187-284``): the torchvision-architecture families (AlexNet, VGG16,
ResNet18/50, ViT-B/16, ECTiedNet) for ``load_model_from=torchvision``,
untrained or with IMAGENET1K weights from a local torchvision file
(``pretrained_dataset=imagenet1k``, ``models/torch_import.py``),
CustomCNN / TinyCustomCNN for ``model_class=custom_model``, and
checkpoints for ``load_model_from=checkpoint``."""
from __future__ import annotations

import torch
from torch import nn

from visreps_tpu_torch.core.config import get_seed_letter
from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.core.profiling import span
from visreps_tpu_torch.device import resolve_device
from visreps_tpu_torch.models.custom_cnn import CustomCNN, TinyCustomCNN
from visreps_tpu_torch.models.ecnet import ECTiedNet
from visreps_tpu_torch.models.resnet import ResNet18, ResNet50
from visreps_tpu_torch.models.standard import VGG16, AlexNet
from visreps_tpu_torch.models.vit import ViTBase

# Default extraction points (reference: visreps/models/utils.py:27-31,
# extended to every family).
TORCHVISION_RETURN_NODES = {
    "AlexNet": ["conv1", "conv2", "conv3", "conv4", "conv5", "fc1", "fc2"],
    "ResNet18": ["conv1", "block1", "block2", "block3", "block4",
                 "block5", "block6", "block7", "block8", "fc1"],
    "ResNet50": ["conv1"] + [f"block{i}" for i in range(1, 17)] + ["fc1"],
    "VGG16": [f"conv{i}" for i in range(1, 14)] + ["fc1", "fc2"],
    "ViTBase": ["patch_embed"] + [f"block{i}" for i in range(1, 13)] + ["head"],
    "ECTiedNet": ["stem"] + [f"block{i}" for i in range(1, 5)] + ["fc1", "fc2"],
}

MODEL_REGISTRY = {
    "AlexNet": AlexNet,
    "VGG16": VGG16,
    "ResNet18": ResNet18,
    "ResNet50": ResNet50,
    "ViTBase": ViTBase,
    "ECTiedNet": ECTiedNet,
    "CustomCNN": CustomCNN,
    "TinyCustomCNN": TinyCustomCNN,
}


def build_model(model_name: str, num_classes: int, arch=None) -> nn.Module:
    """An uninitialised model; CustomCNN / TinyCustomCNN take the config's
    ``arch`` fields (``zoo.py:75-88`` of the JAX package)."""
    if model_name not in MODEL_REGISTRY:
        raise ValueError(f"Model '{model_name}' not found in registry: {list(MODEL_REGISTRY)}")
    if model_name not in ("CustomCNN", "TinyCustomCNN"):
        return MODEL_REGISTRY[model_name](num_classes=num_classes)
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
    same weights on every device) in its family's init. Spans:
    ``zoo.init`` (the build and init on the CPU) and ``zoo.to_device``."""
    device = resolve_device(device)
    with span("zoo.init"):
        model = build_model(model_name, num_classes, arch)
        model.init_weights(torch.Generator().manual_seed(seed))
    with span("zoo.to_device"):
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
    custom_model``), or a torchvision-architecture model, with the local
    IMAGENET1K torchvision weights when ``pretrained_dataset=imagenet1k``."""
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
    model = init_model(model_name, num_classes or 1000, seed=cfg.get("seed", 0), device=device)
    if cfg.get("pretrained_dataset", "none") == "imagenet1k":
        from visreps_tpu_torch.models.torch_import import load_pretrained_torch

        model = load_pretrained_torch(model, model_name, num_classes)
    return model
