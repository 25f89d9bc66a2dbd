"""Per-layer PCA eigenspectra from saved feature .npz files (port of
``visreps_tpu/analysis/compute_eigenspectra.py``): the squared singular
values of each centred (n, d) layer matrix over n − 1, as the JAX package
computes them with an f32 SVD. Here they are the eigenvalues of the
smaller Gram matrix in float64, as ``ops/pca.py`` fits: cuSOLVER's f32
SVD put them 2.4e-4 (of the largest) from an f64 SVD's at (1600, 4096).

Usage:
  python -m visreps_tpu_torch.analysis.compute_eigenspectra feats.npz ... \\
      [--out-dir eigenspectra] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from visreps_tpu_torch.device import input_device, resolve_device


def analyze_layer_pca(features, device: str | torch.device | None = None) -> dict:
    """Full eigenspectrum of one layer's (n, ...) features, on ``device``
    (the tensor's own when ``features`` is one; a numpy input needs it)."""
    device = input_device(features, device)
    x = torch.as_tensor(features).to(device, torch.float32)
    x = x.reshape(x.shape[0], -1)
    x = (x - x.mean(dim=0)).double()
    gram = x @ x.T if x.shape[0] <= x.shape[1] else x.T @ x
    eigvals = torch.linalg.eigvalsh(gram).flip(0).clamp_min(0.0) / (x.shape[0] - 1)
    eigvals = eigvals.to(torch.float32).cpu().numpy()
    total = float(eigvals.sum())
    return {
        "eigenvalues": eigvals,
        "explained_variance_ratio": eigvals / total if total > 0 else eigvals,
        "total_variance": total,
        "effective_dim": float(eigvals.sum() ** 2 / (eigvals**2).sum()) if total > 0 else 0.0,
    }


def process_file(npz_path: str, out_dir: str, device: str | torch.device | None = None) -> str:
    """Every 2-D-or-wider numeric array of ``npz_path`` → its eigenvalues,
    explained-variance ratios and effective dimension, saved as
    ``{out_dir}/eigenspectra_{name}``."""
    device = resolve_device(device)
    data = np.load(npz_path, allow_pickle=True)
    results = {}
    for key in data.files:
        arr = data[key]
        if not isinstance(arr, np.ndarray) or arr.ndim < 2 or arr.dtype.kind not in "fiu":
            continue
        spec = analyze_layer_pca(arr.astype(np.float32), device=device)
        results[f"{key}_eigenvalues"] = spec["eigenvalues"]
        results[f"{key}_evr"] = spec["explained_variance_ratio"]
        results[f"{key}_effective_dim"] = spec["effective_dim"]
        print(f"  {key}: effective dim {spec['effective_dim']:.1f}")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "eigenspectra_" + os.path.basename(npz_path))
    np.savez(out, **results)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("files", nargs="+")
    parser.add_argument("--out-dir", default="eigenspectra")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    for f in args.files:
        print(f"Processing {f}")
        print(f"Saved {process_file(f, args.out_dir, args.device)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
