"""Linear probes on frozen checkpoint features (port of
``experiments/coarse_grain_benefits/linear_probe.py``).

Does coarse-label pretraining give linearly decodable features for a
downstream task? One tap (SRP k = 4096 on the device, the float32 store)
of the train and val splits of a folder dataset, a ridge fit to one-hot
targets with per-class alphas by 5-fold CV (``ops/ridge.ridge_cv``, on
the device), and the top-1 of its argmax readout.

Usage:
  python -m visreps_tpu_torch.experiments.coarse_grain_benefits.linear_probe \\
      --checkpoint-dir DIR --cfg-id 64 --probe-dataset TINY_IMAGENET_ROOT [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from visreps_tpu_torch.core.config import Config
from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.device import resolve_device


class _WithIdx:
    """A labelled dataset yielding (image, (index, label))."""

    def __init__(self, base):
        self.base = base

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx):
        img, label = self.base[idx]
        return img, (idx, label)


def extract_features(model, dataset, layer: str, batch_size: int, image_size: int,
                     device=None):
    """((N, k) float32 SRP features of ``layer`` on the device, (N,) int32
    labels) over a labelled dataset, in its order."""
    from visreps_tpu_torch.data.loader import PrefetchLoader
    from visreps_tpu_torch.models.extractor import FeatureExtractor

    extractor = FeatureExtractor(model, [layer.split("_")[0]], srp_k=4096,
                                 image_size=image_size, device=device)
    loader = PrefetchLoader(_WithIdx(dataset), batch_size=batch_size, shuffle=False,
                            num_workers=8)
    acts, metas = extractor.get_activations(loader, store="host")
    labels = np.asarray([m[1] for m in metas], np.int32)
    return acts[layer].to(extractor.device), labels


def ridge_probe(x_train: torch.Tensor, y_train, x_test: torch.Tensor,
                n_classes: int) -> torch.Tensor:
    """Test-set class predictions of a ridge fit to one-hot targets."""
    from visreps_tpu_torch.ops.ridge import ridge_cv

    labels = torch.as_tensor(np.asarray(y_train), dtype=torch.long, device=x_train.device)
    one_hot = torch.eye(n_classes, dtype=torch.float32, device=x_train.device)[labels]
    return ridge_cv(x_train, one_hot).predict(x_test).argmax(dim=1)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint-dir", required=True)
    parser.add_argument("--cfg-id", required=True)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--checkpoint-model", default="checkpoint_epoch_20.pth")
    parser.add_argument("--layer", default="fc2_post")
    parser.add_argument("--probe-dataset", required=True, help="ImageFolder-style root")
    parser.add_argument("--image-size", type=int, default=224)
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

    tfm = get_transform("imgnet", image_size=args.image_size)
    train_ds = TinyImageNetDataset(args.probe_dataset, "train", tfm)
    test_ds = TinyImageNetDataset(args.probe_dataset, "val", tfm)
    n_classes = train_ds.num_classes

    x_tr, y_tr = extract_features(model, train_ds, args.layer, args.batch_size,
                                  args.image_size, device)
    x_te, y_te = extract_features(model, test_ds, args.layer, args.batch_size,
                                  args.image_size, device)
    pred = ridge_probe(x_tr, y_tr, x_te, n_classes).cpu().numpy()
    top1 = 100.0 * float((pred == y_te).mean())
    rprint(f"Linear probe ({args.layer}) top-1: {top1:.2f}% "
           f"({n_classes} classes, {len(y_tr)} train / {len(y_te)} test)", style="highlight")
    return top1


if __name__ == "__main__":
    main()
