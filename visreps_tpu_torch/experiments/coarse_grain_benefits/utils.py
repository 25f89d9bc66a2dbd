"""Shared helpers for the coarse-grain-benefit experiments (port of
``experiments/coarse_grain_benefits/utils.py``): the (cfg_id, seed)
configurations, loading a configuration's model (torchvision AlexNet for
``"pretrained"``, else ``{checkpoint_dir}/cfg{id}{seed letter}/
{checkpoint_model}``), and one tap's features over a loader.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.device import resolve_device

OUTPUT_DIR = str(Path(__file__).resolve().parent / "results")
DEFAULT_CHECKPOINT_MODEL = "checkpoint_epoch_20.pth"


def ensure_output_dir(path: str | None = None) -> str:
    out = path or OUTPUT_DIR
    os.makedirs(out, exist_ok=True)
    return out


def get_config_name(cfg_id, seed) -> str:
    """'cfg32a'-style name."""
    if cfg_id == "pretrained":
        return "pretrained"
    return f"cfg{cfg_id}{chr(ord('a') + seed - 1)}"


def get_model_configs(cfg_ids=None, seeds=None, include_pretrained=False):
    """(cfg_id, seed) pairs to evaluate."""
    cfg_ids = cfg_ids if cfg_ids is not None else [32, 64, 1000]
    seeds = seeds if seeds is not None else [1]
    configs = [(c, s) for c in cfg_ids for s in seeds]
    if include_pretrained:
        configs.append(("pretrained", None))
    return configs


def load_model_by_config(cfg_id, seed, checkpoint_dir=None,
                         checkpoint_model=DEFAULT_CHECKPOINT_MODEL, device=None):
    """The model of a (cfg_id, seed) pair, or torchvision's pretrained
    AlexNet, on ``device`` (CUDA unless ``"cpu"`` is asked for)."""
    from visreps_tpu_torch.core.config import Config
    from visreps_tpu_torch.models.zoo import load_model

    if cfg_id == "pretrained":
        return load_model(Config({
            "load_model_from": "torchvision", "model_name": "AlexNet",
            "pretrained_dataset": "imagenet1k",
        }), device=device)
    checkpoint_dir = checkpoint_dir or os.environ.get("CHECKPOINT_DIR", "checkpoints")
    path = os.path.join(checkpoint_dir, get_config_name(cfg_id, seed), checkpoint_model)
    if not os.path.exists(path):
        raise FileNotFoundError(f"Checkpoint not found: {path}")
    from visreps_tpu_torch.train.checkpoint import load_checkpoint

    model, _ = load_checkpoint(path, device=device)
    return model


@torch.inference_mode()
def extract_features(model, loader, layer: str = "fc2", post_relu: bool = True,
                     device=None) -> np.ndarray:
    """(N, d) float32 features of one tap over a loader of (batch, *rest),
    a conv tap flattened in (H, W, C) order."""
    from visreps_tpu_torch.models.extractor import _flatten_hwc
    from visreps_tpu_torch.train.trainer import images_to_device

    device = resolve_device(device)
    model = model.to(device).eval()
    point = f"{layer}_{'post' if post_relu else 'pre'}"
    parts = []
    for batch in loader:
        x = batch[0] if isinstance(batch, (tuple, list)) else batch
        tap = model(images_to_device(np.asarray(x), device), capture=(point,))[1][point]
        parts.append(_flatten_hwc(tap).to("cpu", torch.float32))
    feats = torch.cat(parts).numpy()
    rprint(f"  extracted {layer}: {feats.shape}", style="info")
    return feats
