"""CLIP image embeddings (L2-normalised) of every ImageNet image (port of
``scripts/extract_representations/clip_representations.py``).

Per batch, on the device: the ImageNet → CLIP pixel renormalisation, a
bilinear resize to the tower's input size where the batch differs
(``ops/resize.py``: ``jax.image.resize``'s filter, antialiased when
downsampling, as the JAX script resizes), the CLIP vision tower's
``embed`` output (``models/hf_vit.py``), and the L2 normalisation.

Weights: ``models/hf_vit.load_tower`` (the converted-tower pickle under
``VISREPS_TOWER_CACHE``, else an HF snapshot on disk; neither raises).

Usage:
  python -m visreps_tpu_torch.scripts.extract_representations.clip_representations \\
      --out features_clip.npz [--batch-size 128] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from visreps_tpu_torch.device import resolve_device
from visreps_tpu_torch.ops.resize import resize
from visreps_tpu_torch.scripts.extract_representations.utils import extract_and_save

# CLIP normalization stats differ from ImageNet's
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
IMGNET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMGNET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _channels(stats: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(stats, device=device).reshape(1, 3, 1, 1)


def clip_pixels(x: torch.Tensor, image_size: int) -> torch.Tensor:
    """(B, 3, H, W) ImageNet-normalised → CLIP-normalised at
    ``image_size`` × ``image_size``."""
    x = x * _channels(IMGNET_STD, x.device) + _channels(IMGNET_MEAN, x.device)
    x = (x - _channels(CLIP_MEAN, x.device)) / _channels(CLIP_STD, x.device)
    if x.shape[2] != image_size or x.shape[3] != image_size:
        x = resize(x, (*x.shape[:2], image_size, image_size), "bilinear")
    return x


def build_extract(tower, image_size: int, device: torch.device):
    """(b, h, w, 3) ImageNet-normalised float32 host batch → (b, E)
    L2-normalised embeddings (the tower's ``embed`` output)."""
    from visreps_tpu_torch.train.trainer import images_to_device

    @torch.inference_mode()
    def extract(batch):
        emb, _ = tower(clip_pixels(images_to_device(batch, device), image_size))
        return emb / torch.linalg.norm(emb, dim=-1, keepdim=True)

    return extract


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="openai/clip-vit-large-patch14")
    parser.add_argument("--out", default="features_clip.npz")
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from visreps_tpu_torch.models.hf_vit import load_tower

    device = resolve_device(args.device)
    image_size = 224  # load_tower's input size, the JAX tower state's input_size
    tower = load_tower(args.model, pretrained=True, image_size=image_size, device=device)
    return extract_and_save(build_extract(tower, image_size, device), args.out,
                            batch_size=args.batch_size)


if __name__ == "__main__":
    main()
