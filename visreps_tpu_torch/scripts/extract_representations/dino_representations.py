"""DINOv2 CLS features of every ImageNet image (port of
``scripts/extract_representations/dino_representations.py``): the
tower's pooled (final-LN) CLS row, with the position grid resampled to
the input size (``models/hf_vit.interpolate_positions``, as the JAX
script resamples it at conversion).

Weights: ``models/hf_vit.load_tower`` (the converted-tower pickle under
``VISREPS_TOWER_CACHE``, else an HF snapshot on disk; neither raises).

Usage:
  python -m visreps_tpu_torch.scripts.extract_representations.dino_representations \\
      --out features_dino.npz [--batch-size 128] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from visreps_tpu_torch.device import resolve_device
from visreps_tpu_torch.scripts.extract_representations.utils import extract_and_save


def build_extract(tower, device: torch.device, image_size: int | None = None):
    """(b, h, w, 3) float32 host batch → (b, hidden) CLS features. With
    ``image_size`` the tower's position grid is first resampled (in
    place) to that input size."""
    from visreps_tpu_torch.models.hf_vit import interpolate_positions
    from visreps_tpu_torch.train.trainer import images_to_device

    if image_size is not None:
        n_patches = (image_size // tower.patch_size) ** 2
        with torch.no_grad():
            pos = interpolate_positions(tower.pos_embedding.detach().cpu(), n_patches)
            tower.pos_embedding = torch.nn.Parameter(pos.to(tower.pos_embedding.device))

    @torch.inference_mode()
    def extract(batch):
        return tower(images_to_device(batch, device))[0]

    return extract


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="facebook/dinov2-large")
    parser.add_argument("--out", default="features_dino.npz")
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from visreps_tpu_torch.models.hf_vit import load_tower

    device = resolve_device(args.device)
    tower = load_tower(args.model, pretrained=True, device=device)
    return extract_and_save(build_extract(tower, device), args.out, batch_size=args.batch_size)


if __name__ == "__main__":
    main()
