"""Class-selectivity index of units across checkpoints (port of
``experiments/coarse_grain_benefits/class_selectivity.py``): for each unit
of a tap, (μ_max − μ_rest) / (μ_max + μ_rest) over its per-class mean
activations (Morcos et al. 2018), on the features' device; the
distribution per layer is printed.

Usage:
  python -m visreps_tpu_torch.experiments.coarse_grain_benefits.class_selectivity \\
      --checkpoint-dir DIR --cfg-id 64 --probe-dataset TINY_IMAGENET_ROOT [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from visreps_tpu_torch.core.config import Config
from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.device import input_device, resolve_device
from visreps_tpu_torch.experiments.coarse_grain_benefits.linear_probe import extract_features


def class_selectivity(features, labels, device=None) -> torch.Tensor:
    """(n, units) × (n,) → per-unit selectivity index in [0, 1]."""
    device = input_device(features, device)
    f = torch.as_tensor(features).to(device, torch.float32)
    _, inverse = np.unique(np.asarray(labels), return_inverse=True)
    inverse = torch.as_tensor(inverse.reshape(-1), device=device)
    n_classes = int(inverse.max()) + 1
    sums = torch.zeros((n_classes, f.shape[1]), dtype=torch.float32, device=device)
    sums.index_add_(0, inverse, f)
    means = sums / torch.bincount(inverse, minlength=n_classes).to(torch.float32)[:, None]
    mu_max = means.max(dim=0).values
    mu_rest = (means.sum(dim=0) - mu_max) / max(n_classes - 1, 1)
    denom = mu_max + mu_rest
    denom = torch.where(denom.abs() < 1e-9, 1.0, denom)
    return torch.clamp((mu_max - mu_rest) / denom, 0.0, 1.0)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint-dir", required=True)
    parser.add_argument("--cfg-id", required=True)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--checkpoint-model", default="checkpoint_epoch_20.pth")
    parser.add_argument("--layers", nargs="+", default=["conv5_post", "fc2_post"])
    parser.add_argument("--probe-dataset", required=True)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from visreps_tpu_torch.data.obj_cls import TinyImageNetDataset
    from visreps_tpu_torch.data.transforms import get_transform
    from visreps_tpu_torch.models.zoo import load_model

    device = resolve_device(args.device)
    cfg = Config({
        "load_model_from": "checkpoint", "seed": args.seed, "cfg_id": args.cfg_id,
        "checkpoint_dir": args.checkpoint_dir, "checkpoint_model": args.checkpoint_model,
    })
    model = load_model(cfg, device=device)
    ds = TinyImageNetDataset(args.probe_dataset, "val", get_transform("imgnet"))

    results = {}
    for layer in args.layers:
        feats, labels = extract_features(model, ds, layer, args.batch_size, 224, device)
        sel = class_selectivity(feats, labels).cpu().numpy()
        results[layer] = sel
        rprint(
            f"{layer}: selectivity mean {sel.mean():.3f}, median {np.median(sel):.3f}, "
            f"frac>0.5 {float((sel > 0.5).mean()):.3f} ({feats.shape[1]} units)",
            style="highlight",
        )
    return results


if __name__ == "__main__":
    main()
