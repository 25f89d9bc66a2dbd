"""AlexNet fc2 features of every ImageNet image, the PCA-label source
(port of ``scripts/extract_representations/alexnet_representations.py``):
the ``fc2_post`` tap (4096-d) of AlexNet with IMAGENET1K weights, saved
to features_alexnet.npz. Without the torchvision weight file under
``TORCH_WEIGHTS_DIR`` it warns and keeps the seeded init, as the JAX
script does.

Usage:
  python -m visreps_tpu_torch.scripts.extract_representations.alexnet_representations \\
      --out features_alexnet.npz [--batch-size 256] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from visreps_tpu_torch.device import resolve_device
from visreps_tpu_torch.scripts.extract_representations.utils import extract_and_save

TAP = "fc2_post"


def build_extract(model, device: torch.device):
    """(b, h, w, 3) float32 host batch → (b, 4096) ``fc2_post`` on ``device``."""
    from visreps_tpu_torch.train.trainer import images_to_device

    @torch.inference_mode()
    def extract(batch):
        return model(images_to_device(batch, device), capture=(TAP,))[1][TAP]

    return extract


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="features_alexnet.npz")
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from visreps_tpu_torch.models.torch_import import load_pretrained_torch
    from visreps_tpu_torch.models.zoo import init_model

    device = resolve_device(args.device)
    model = init_model("AlexNet", 1000, seed=0, device=device)
    model = load_pretrained_torch(model, "AlexNet", 1000)
    return extract_and_save(build_extract(model, device), args.out, batch_size=args.batch_size)


if __name__ == "__main__":
    main()
