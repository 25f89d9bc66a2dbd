"""PLSSVD cross-decomposition alignment with K-fold CV (port of
``visreps_tpu/analysis/cross_decomposition.py``): activations and neural
responses each reduced by a Gaussian random projection, PLSSVD fitted on
each training fold, and the mean correlation of paired test-fold scores
reported; results optionally appended to a pickle.

The projection is drawn from a ``torch.Generator`` on the CPU (the same
matrix on every device; not ``jax.random``'s bits). The SVD of the
(d, d) cross-covariance runs in float64, so that the card and the CPU
pick the same singular vectors where singular values lie close.
"""
from __future__ import annotations

import math
import os
import pickle

import numpy as np
import torch

from visreps_tpu_torch.device import input_device


def gaussian_matrix(d: int, k: int, seed: int) -> torch.Tensor:
    """(d, k) N(0, 1/k) float32 entries from ``Generator().manual_seed(seed)``, on the CPU."""
    return torch.randn((d, k), generator=torch.Generator().manual_seed(seed)) / math.sqrt(k)


def gaussian_random_projection(x: torch.Tensor, k: int = 1000, seed: int = 0) -> torch.Tensor:
    """(n, d) → (n, k) by ``gaussian_matrix(d, k, seed)``; float32 x
    unchanged when d ≤ k."""
    x = x.to(torch.float32)
    if x.shape[1] <= k:
        return x
    return x @ gaussian_matrix(x.shape[1], k, seed).to(x.device)


def _plssvd_fit(x: torch.Tensor, y: torch.Tensor, n_components: int):
    """PLSSVD: the SVD of Xᵀ Y after column centring (in float64)."""
    xm, ym = x.mean(dim=0), y.mean(dim=0)
    u, _, vt = torch.linalg.svd(((x - xm).T @ (y - ym)).double(), full_matrices=False)
    return u[:, :n_components].float(), vt[:n_components].T.float(), xm, ym


def compute_cross_decomposition_alignment(
    acts, neural, n_components: int = 25, n_folds: int = 8, proj_dim: int = 1000,
    seed: int = 0, out_pickle: str | None = None, tag: str = "",
    device: str | torch.device | None = None,
) -> dict:
    """Mean CV correlation of paired PLSSVD scores, on ``device`` (the
    tensor's own when ``acts`` is one; a numpy input needs it). Folds come
    from ``RandomState(seed).permutation``; each fold's score is the mean
    over components of the test-score correlations (components with a
    constant score skipped)."""
    device = input_device(acts, device)
    a = torch.as_tensor(acts).to(device)
    x = gaussian_random_projection(a.reshape(a.shape[0], -1), proj_dim, seed)
    y = gaussian_random_projection(torch.as_tensor(neural).to(device), proj_dim, seed + 1)
    n = x.shape[0]
    n_components = min(n_components, x.shape[1], y.shape[1])
    folds = np.array_split(np.random.RandomState(seed).permutation(n), n_folds)

    fold_corrs = []
    for i in range(n_folds):
        test = torch.as_tensor(folds[i], device=device)
        train = torch.as_tensor(np.concatenate([folds[j] for j in range(n_folds) if j != i]),
                                device=device)
        u, v, xm, ym = _plssvd_fit(x[train], y[train], n_components)
        xs = ((x[test] - xm) @ u).cpu().numpy()
        ys = ((y[test] - ym) @ v).cpu().numpy()
        corrs = [np.corrcoef(xs[:, c], ys[:, c])[0, 1] for c in range(n_components)
                 if np.std(xs[:, c]) > 0 and np.std(ys[:, c]) > 0]
        fold_corrs.append(np.mean(corrs) if corrs else np.nan)

    result = {"tag": tag, "mean_cv_correlation": float(np.nanmean(fold_corrs)),
              "fold_correlations": [float(c) for c in fold_corrs],
              "n_components": n_components}
    if out_pickle:
        prior = []
        if os.path.exists(out_pickle):
            with open(out_pickle, "rb") as f:
                prior = pickle.load(f)
        prior.append(result)
        with open(out_pickle, "wb") as f:
            pickle.dump(prior, f)
    return result
