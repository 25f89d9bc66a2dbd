"""Augmentation invariance of checkpoint representations (port of
``experiments/coarse_grain_benefits/augmentation_invariance.py``): the
cosine similarity between a tap's SRP activations for clean and
augmented (flip and a small rotation, ``data/augment.py``) versions of
the same images — higher is more invariant. The augmentations draw from
an explicit ``torch.Generator`` on the device, seeded with 0 (the JAX
module's ``jax.random`` draws cannot be reproduced bit for bit).

Usage:
  python -m visreps_tpu_torch.experiments.coarse_grain_benefits.augmentation_invariance \\
      --checkpoint-dir DIR --cfg-id 64 --probe-dataset TINY_IMAGENET_ROOT [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from visreps_tpu_torch.core.config import Config
from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.device import resolve_device


def cosine_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise cosine similarity, with 1e-8 added to the norms' product."""
    num = (a * b).sum(dim=1)
    return num / (torch.linalg.norm(a, dim=1) * torch.linalg.norm(b, dim=1) + 1e-8)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint-dir", required=True)
    parser.add_argument("--cfg-id", required=True)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--checkpoint-model", default="checkpoint_epoch_20.pth")
    parser.add_argument("--layers", nargs="+", default=["conv5", "fc2"])
    parser.add_argument("--probe-dataset", required=True)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--max-batches", type=int, default=8)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from visreps_tpu_torch.data.augment import augment_batch
    from visreps_tpu_torch.data.loader import PrefetchLoader
    from visreps_tpu_torch.data.obj_cls import TinyImageNetDataset
    from visreps_tpu_torch.data.transforms import get_transform
    from visreps_tpu_torch.models.extractor import FeatureExtractor
    from visreps_tpu_torch.models.zoo import load_model

    device = resolve_device(args.device)
    cfg = Config({
        "load_model_from": "checkpoint", "seed": args.seed, "cfg_id": args.cfg_id,
        "checkpoint_dir": args.checkpoint_dir, "checkpoint_model": args.checkpoint_model,
    })
    model = load_model(cfg, device=device)
    extractor = FeatureExtractor(model, args.layers, srp_k=4096, image_size=224, device=device)

    ds = TinyImageNetDataset(args.probe_dataset, "val", get_transform("imgnet"))
    loader = PrefetchLoader(ds, batch_size=args.batch_size, shuffle=False, num_workers=8)

    sims: dict[str, list] = {}
    gen = torch.Generator(device=device).manual_seed(0)
    for i, (batch, _) in enumerate(loader):
        if i >= args.max_batches or batch.shape[0] < args.batch_size:
            break
        x = extractor._to_device(batch)
        clean = extractor.srp_batch(x)
        aug = extractor.srp_batch(augment_batch(x, gen))
        for name in clean:
            sims.setdefault(name, []).append(cosine_rows(clean[name], aug[name]))

    results = {}
    for name, parts in sims.items():
        vals = torch.cat(parts).cpu().numpy()
        results[name] = vals
        rprint(f"{name}: augmentation cosine invariance "
               f"{np.mean(vals):.4f} ± {np.std(vals):.4f} (n={len(vals)})",
               style="highlight")
    return results


if __name__ == "__main__":
    main()
