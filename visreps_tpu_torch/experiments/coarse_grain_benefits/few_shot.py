"""k-shot classification from frozen checkpoint features (port of
``experiments/coarse_grain_benefits/few_shot.py``).

Nearest-class-mean episodes: k examples per class become its prototype,
the rest are classified by cosine similarity to the prototypes. The
episodes draw from ``np.random.RandomState(seed)`` in the JAX module's
order, so both packages sample the same episodes; the prototypes and
the scoring run on the features' device.

Transfer dataset: the local Tiny-ImageNet (``--dataset-type
tinyimagenet``, the default) or a local CIFAR-100 copy
(``--dataset-type cifar100``: ``ROOT/cifar-100-python/{train,test}``,
the python-pickle archive, read without torchvision; nothing is
downloaded).

Usage:
  python -m visreps_tpu_torch.experiments.coarse_grain_benefits.few_shot \\
      --checkpoint-dir DIR --cfg-id 64 --probe-dataset ROOT [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch

from visreps_tpu_torch.core.config import Config
from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.device import input_device, resolve_device
from visreps_tpu_torch.experiments.coarse_grain_benefits.linear_probe import extract_features


class CIFAR100Probe:
    """(image, fine label) view over a local CIFAR-100 python archive
    (``root/cifar-100-python/{train,test}``, torchvision's layout). The
    archive is unpickled: use a copy from a trusted source."""

    def __init__(self, root: str, split: str, transform):
        path = os.path.join(root, "cifar-100-python", "train" if split == "train" else "test")
        with open(path, "rb") as f:
            entry = pickle.load(f, encoding="latin1")
        self.images = entry["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self.labels = list(entry["fine_labels"])
        self.transform = transform

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, idx):
        return self.transform(self.images[idx]), self.labels[idx]


def few_shot_episodes(features, labels, k_shot, n_episodes, seed=0, device=None):
    """(mean, std) top-1 % over ``n_episodes`` nearest-prototype episodes."""
    device = input_device(features, device)
    rng = np.random.RandomState(seed)
    f = torch.as_tensor(features).to(device, torch.float32)
    feats = f / (torch.linalg.norm(f, dim=1, keepdim=True) + 1e-8)
    labels = np.asarray(labels)
    members = [np.where(labels == c)[0] for c in np.unique(labels)]
    accs = []
    for _ in range(n_episodes):
        picks, test_idx, test_y = [], [], []
        for idx in members:
            if len(idx) <= k_shot:
                continue
            pick = rng.choice(idx, size=k_shot, replace=False)
            rest = np.setdiff1d(idx, pick)
            picks.append(pick)
            test_idx.append(rest)
            test_y.append(np.full(len(rest), len(picks) - 1))
        protos = feats[torch.as_tensor(np.stack(picks), device=device)].mean(dim=1)
        test_x = feats[torch.as_tensor(np.concatenate(test_idx), device=device)]
        test_y = torch.as_tensor(np.concatenate(test_y), device=device)
        hits = int(((test_x @ protos.T).argmax(dim=1) == test_y).sum())
        accs.append(100.0 * (hits / len(test_y)))
    return float(np.mean(accs)), float(np.std(accs))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint-dir", required=True)
    parser.add_argument("--cfg-id", required=True)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--checkpoint-model", default="checkpoint_epoch_20.pth")
    parser.add_argument("--layer", default="fc2_post")
    parser.add_argument("--probe-dataset", required=True)
    parser.add_argument("--dataset-type", choices=["tinyimagenet", "cifar100"],
                        default="tinyimagenet",
                        help="cifar100 matches the reference's transfer "
                             "dataset (local copy required)")
    parser.add_argument("--k-shot", type=int, nargs="+", default=[1, 5, 10, 20])
    parser.add_argument("--episodes", type=int, default=20)
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
    tfm = get_transform("imgnet")
    if args.dataset_type == "cifar100":
        ds = CIFAR100Probe(args.probe_dataset, "test", tfm)
    else:
        ds = TinyImageNetDataset(args.probe_dataset, "val", tfm)
    feats, labels = extract_features(model, ds, args.layer, args.batch_size, 224, device)

    results = {}
    for k in args.k_shot:
        mean, std = few_shot_episodes(feats, labels, k, args.episodes)
        results[k] = (mean, std)
        rprint(f"{k}-shot: {mean:.2f}% ± {std:.2f} ({args.episodes} episodes)",
               style="highlight")
    return results


if __name__ == "__main__":
    main()
