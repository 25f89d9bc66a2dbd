"""PCA coarse labels: median-split bits on the top PCs → 2^n classes
(port of ``scripts/coarsegrain/make_pca_labels.py``).

Project the features onto the top eigenvectors, split each PC at its
global median, and read the n bits as a class id (nested: the 2^n
classes refine the 2^(n−1) ones), one CSV per granularity with columns
(image, pca_label). On the device, with no pandas:

  * the median is ``np.median``'s: the middle value, or for an even
    count the mean of the two middle values (``torch.median`` would
    take the lower one);
  * the CSVs are written by ``csv`` with ``\\n`` line ends, as pandas'
    ``to_csv`` writes them, so they are byte-identical to the JAX
    script's from the same features and eigenvectors;
  * the projection is made once for every granularity, so the labels
    are nested by construction;
  * no sign rule is added: ``eigh`` returns each eigenvector with an
    arbitrary sign, and a flipped vector inverts its bit for every
    image, in this package as in the JAX one.

Usage:
  python -m visreps_tpu_torch.scripts.coarsegrain.make_pca_labels \\
      --features features_alexnet.npz --eigen eigenvectors_alexnet.npz \\
      --out-dir pca_labels/pca_labels_alexnet --max-bits 6 [--device cpu]
"""
from __future__ import annotations

import argparse
import csv
import os

import numpy as np
import torch

from visreps_tpu_torch.device import input_device, resolve_device


def np_median(x: torch.Tensor) -> torch.Tensor:
    """Per-column median of (N, k) as ``np.median(x, axis=0)`` takes it."""
    s = torch.sort(x, dim=0).values
    n = x.shape[0]
    if n % 2:
        return s[n // 2]
    return (s[n // 2 - 1] + s[n // 2]) / 2


def project(features, eigenvectors, mean, n_bits: int, device=None) -> torch.Tensor:
    """(N, n_bits) float32 projections (features − mean) @ top eigenvectors,
    on ``device`` (default: the features')."""
    device = input_device(features, device)
    f = torch.as_tensor(features).to(device, torch.float32)
    v = torch.as_tensor(eigenvectors).to(device, torch.float32)[:, :n_bits]
    return (f - torch.as_tensor(mean).to(device, torch.float32)) @ v


def bit_labels(proj: torch.Tensor) -> torch.Tensor:
    """(N,) int64 labels: bit j (most significant first) is projection j
    above its median."""
    n_bits = proj.shape[1]
    bits = (proj > np_median(proj)).to(torch.int64)
    weights = 2 ** torch.arange(n_bits - 1, -1, -1, device=proj.device)
    return (bits * weights).sum(dim=1)


def pca_bit_labels(features, eigenvectors, mean, n_bits: int, device=None) -> torch.Tensor:
    """(N,) int64 labels from n_bits median-split PC projections."""
    return bit_labels(project(features, eigenvectors, mean, n_bits, device))


def write_labels(path: str, image_ids, labels) -> None:
    """``image,pca_label`` CSV as pandas' ``to_csv(index=False)`` writes it."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(["image", "pca_label"])
        writer.writerows(zip(image_ids, np.asarray(labels).tolist()))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--features", required=True, help=".npz with 'features' and 'image_ids'")
    parser.add_argument("--eigen", required=True, help="output of compute_eigenvectors")
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--max-bits", type=int, default=6)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    data = np.load(args.features, allow_pickle=True)
    feats = data["features"].astype(np.float32)
    image_ids = [str(s) for s in data["image_ids"]]
    eig = np.load(args.eigen)
    proj = project(feats, eig["eigenvectors"], eig["mean"], args.max_bits, device)

    os.makedirs(args.out_dir, exist_ok=True)
    for n_bits in range(1, args.max_bits + 1):
        labels = bit_labels(proj[:, :n_bits]).cpu().numpy()
        n_classes = 2 ** n_bits
        out = os.path.join(args.out_dir, f"n_classes_{n_classes}.csv")
        write_labels(out, image_ids, labels)
        counts = np.bincount(labels, minlength=n_classes)
        print(
            f"{out}: {n_classes} classes, images/class "
            f"min {counts.min()} / max {counts.max()} / mean {counts.mean():.0f}"
        )


if __name__ == "__main__":
    main()
