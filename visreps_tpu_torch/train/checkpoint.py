"""Checkpoints in the JAX package's format (port of
``visreps_tpu/train/checkpoint.py:33-58, 61-72, 97-152``).

Directory ``model_checkpoints/{checkpoint_dir}/cfg{K}{seed_letter}/``
(``K`` = ``pca_n_classes`` with PCA labels, else 200 / 1000; an absolute
``checkpoint_dir`` is used as it is), a ``config.json`` with
``total_params`` and ``trainable_params``, and files
``checkpoint_epoch_{e}.pth`` holding a pickle payload: ``epoch``,
``module_spec`` (class name and constructor fields), ``params`` and
``batch_stats`` as numpy arrays in the Flax layout, ``input_size``,
``metrics`` and ``config``. Weights convert at save and load through
``models/convert.py``, so a checkpoint written by either package loads
in the other. Optimizer state is not saved. The reference's own
checkpoints (a torch zip file holding the whole pickled module) load
through ``models/torch_import.load_reference_checkpoint``.
"""
from __future__ import annotations

import json
import os
import pickle
from pathlib import Path

import torch
from torch import nn

from visreps_tpu_torch.core.config import get_seed_letter
from visreps_tpu_torch.device import resolve_device
from visreps_tpu_torch.models.convert import params_from_jax, params_to_jax


def setup_checkpoint_dir(cfg, model: nn.Module) -> tuple[str, dict]:
    """Create the checkpoint directory and its config.json; returns
    (path, the config dict every checkpoint stores)."""
    if cfg.get("pca_labels", False):
        cfg_num = cfg.pca_n_classes
    else:
        cfg_num = 200 if cfg.get("dataset") == "tiny-imagenet" else 1000
    path = os.path.join("model_checkpoints", cfg.checkpoint_dir,
                        f"cfg{cfg_num}{get_seed_letter(cfg.seed)}")
    os.makedirs(path, exist_ok=True)
    n_params = sum(p.numel() for p in model.parameters())
    mask = model.trainable_mask() if hasattr(model, "trainable_mask") else {}
    trainable = sum(p.numel() for name, p in model.named_parameters()
                    if mask.get(name.split(".")[0], True))
    cfg_dict = {"total_params": int(n_params),
                "trainable_params": int(trainable if mask else n_params),
                **(cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg))}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg_dict, f, indent=2)
    return path, cfg_dict


def save_checkpoint(checkpoint_dir: str, epoch: int, model: nn.Module, metrics: dict,
                    cfg_dict: dict) -> str:
    params, batch_stats = params_to_jax(model.state_dict(), getattr(model, "num_heads", None))
    payload = {
        "epoch": epoch,
        "module_spec": model.spec(),
        "params": params,
        "batch_stats": batch_stats,
        "input_size": getattr(model, "INPUT_SIZE", 224),
        "metrics": metrics,
        "config": cfg_dict,
    }
    path = os.path.join(checkpoint_dir, f"checkpoint_epoch_{epoch}.pth")
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return path


def build_from_spec(spec: dict) -> nn.Module:
    """The module a ``module_spec`` names, from its constructor fields (a
    ResNet's ``block_cls`` is stored as ``"__class__:Name"``)."""
    from visreps_tpu_torch.models.resnet import ResNet
    from visreps_tpu_torch.models.zoo import MODEL_REGISTRY

    kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in spec.items() if k != "class"}
    ctor = ResNet if spec["class"] == "ResNet" else MODEL_REGISTRY.get(spec["class"])
    if ctor is None:
        raise ValueError(f"Unknown module class in checkpoint: {spec['class']}")
    return ctor(**kwargs)


def load_checkpoint(path: str | Path, device: str | torch.device | None = None):
    """(model in eval mode on ``device``, payload) from a checkpoint file
    written by either package, or from the reference's torch-zip file
    (payload ``{"config": its config}``). Unpickles the file: load only
    checkpoints from a trusted source."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"PK":
        from visreps_tpu_torch.models.torch_import import load_reference_checkpoint

        model, config = load_reference_checkpoint(path, device=device)
        return model, {"config": config}
    with open(path, "rb") as f:
        payload = pickle.load(f)
    model = build_from_spec(payload["module_spec"])
    model.load_state_dict(params_from_jax(payload["params"], payload.get("batch_stats")))
    return model.to(device).eval(), payload
