"""Two-NN intrinsic dimensionality, Facco et al. 2017 (port of
``visreps_tpu/analysis/compute_twonn_id.py``): the ID from the ratio of
each point's second to first nearest-neighbour distance, a decimation
stability check, CSV rows appended. The neighbour search is exact:
pairwise squared distances by the Gram trick, then ``torch.topk``.

Usage:
  python -m visreps_tpu_torch.analysis.compute_twonn_id feats.npz ... \\
      [--out-csv twonn_id.csv] [--device cpu]
"""
from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np
import torch

from visreps_tpu_torch.device import input_device, resolve_device


def _two_nn_ratios(x: torch.Tensor) -> torch.Tensor:
    """mu_i = d2 / d1 per point (float32, x's device)."""
    sq = (x * x).sum(dim=1)
    d2 = (sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)).clamp_min(0.0)
    d2.fill_diagonal_(float("inf"))
    nearest = -torch.topk(-d2, 2, dim=1).values  # the two smallest per row
    return nearest[:, 1].sqrt() / nearest[:, 0].sqrt().clamp_min(1e-12)


def twoNN_id(x, discard_fraction: float = 0.1, device: str | torch.device | None = None) -> float:
    """Facco's Two-NN estimator: the slope of −log(1 − F) against log(mu)
    through the origin, the largest ``discard_fraction`` of mu dropped."""
    device = input_device(x, device)
    mu = _two_nn_ratios(torch.as_tensor(x).to(device, torch.float32)).cpu().numpy()
    mu = np.sort(mu[np.isfinite(mu) & (mu > 1.0)])
    n = len(mu)
    if n < 10:
        return float("nan")
    keep = int(n * (1 - discard_fraction))
    mu = mu[:keep]
    f = np.arange(1, keep + 1) / n
    xlog = np.log(mu)
    ylog = -np.log(1 - f)
    return float((xlog @ ylog) / (xlog @ xlog))


def intrinsic_dim_layer(features, n_decimations: int = 3, seed: int = 0,
                        device: str | torch.device | None = None) -> dict:
    """The ID of (n, ...) features and its half-sample re-estimates
    (``RandomState(seed)`` picks each half)."""
    device = input_device(features, device)
    feats = torch.as_tensor(features).to(device, torch.float32)
    feats = feats.reshape(feats.shape[0], -1)
    full_id = twoNN_id(feats)
    rng = np.random.RandomState(seed)
    half_ids = []
    for _ in range(n_decimations):
        idx = rng.choice(len(feats), size=len(feats) // 2, replace=False)
        half_ids.append(twoNN_id(feats[torch.as_tensor(idx, device=device)]))
    return {"id": full_id, "id_half_mean": float(np.nanmean(half_ids)),
            "id_half_std": float(np.nanstd(half_ids)), "n_samples": len(feats)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("files", nargs="+", help=".npz feature files")
    parser.add_argument("--out-csv", default="twonn_id.csv")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    write_header = not os.path.exists(args.out_csv)
    with open(args.out_csv, "a", newline="") as f:
        writer = csv.DictWriter(
            f, fieldnames=["file", "layer", "id", "id_half_mean", "id_half_std", "n_samples"])
        if write_header:
            writer.writeheader()
        for path in args.files:
            data = np.load(path, allow_pickle=True)
            for key in data.files:
                arr = data[key]
                if not isinstance(arr, np.ndarray) or arr.ndim < 2:
                    continue
                res = intrinsic_dim_layer(arr, device=device)
                writer.writerow({"file": os.path.basename(path), "layer": key, **res})
                print(f"{path}:{key} ID={res['id']:.2f} (half: {res['id_half_mean']:.2f}"
                      f"±{res['id_half_std']:.2f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
