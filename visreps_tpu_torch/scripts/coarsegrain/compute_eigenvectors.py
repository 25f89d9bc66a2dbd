"""Exact PCA eigenvectors of a feature matrix via batched covariance
(port of ``scripts/coarsegrain/compute_eigenvectors.py``): the feature
batches stream through ``ops/pca.fit_pca_covariance`` on the device
(float32 sums, one eigh), and the top-K eigenvectors, eigenvalues, the
mean and the total variance are saved under the JAX script's keys.

Usage:
  python -m visreps_tpu_torch.scripts.coarsegrain.compute_eigenvectors \\
      --features features_alexnet.npz --out eigenvectors_alexnet.npz --top-k 20 [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from visreps_tpu_torch.device import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--features", required=True, help=".npz with 'features' (N, D)")
    parser.add_argument("--out", required=True)
    parser.add_argument("--top-k", type=int, default=20)
    parser.add_argument("--batch-size", type=int, default=4096)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from visreps_tpu_torch.ops.pca import fit_pca_covariance

    device = resolve_device(args.device)
    data = np.load(args.features)
    feats = data["features"]
    n, d = feats.shape
    print(f"Features: {n} x {d}")

    def batches():
        for i in range(0, n, args.batch_size):
            yield feats[i: i + args.batch_size]

    eigvecs, eigvals, mean, total_var = fit_pca_covariance(batches(), d, args.top_k,
                                                           device=device)
    eigvals = eigvals.cpu().numpy()
    total_var = float(total_var)
    np.savez(
        args.out,
        eigenvectors=eigvecs.cpu().numpy(),
        eigenvalues=eigvals,
        mean=mean.cpu().numpy(),
        total_variance=total_var,
    )
    print(f"Top-{args.top_k} variance ratios: {np.round(eigvals / total_var, 4)}")
    print(f"Saved {args.out}")


if __name__ == "__main__":
    main()
