"""Dimensionality metrics (port of
``experiments/representation_analysis/dim_metrics.py``).

The eigenspectrum (f32 ``eigvalsh`` of the covariance, or of the smaller
Gram when d > n), the Two-NN distance matrix and its three smallest
entries per row, Hoyer sparsity and the active fraction run in torch on
the features' device. What the JAX module keeps in numpy stays numpy on
the host: the participation ratio and cumulative variance of the
eigenvalues, and Two-NN's ``default_rng`` subsample and 100-resample
bootstrap, so the seeded streams are the same. Functions take a tensor,
or an array with ``device=``.
"""
from __future__ import annotations

import numpy as np
import torch

from visreps_tpu_torch.device import input_device, resolve_device


def _f32(x, device) -> torch.Tensor:
    device = resolve_device(input_device(x, device))
    return torch.as_tensor(x).to(device, torch.float32)


def _eigenspectrum_impl(x: torch.Tensor) -> torch.Tensor:
    x = x - x.mean(dim=0)
    n, d = x.shape
    # Gram trick: same non-zero eigenvalues from the smaller matrix.
    m = (x @ x.T) / (n - 1) if d > n else (x.T @ x) / (n - 1)
    return torch.linalg.eigvalsh(m).flip(0).clamp_min(0.0)


def eigenspectrum(x, device=None) -> np.ndarray:
    """Covariance eigenvalues, descending, clipped at 0 (float32)."""
    return _eigenspectrum_impl(_f32(x, device)).cpu().numpy()


def _participation_ratio(eigs: np.ndarray) -> float:
    total = eigs.sum()
    if total == 0:
        return 0.0
    return float(total**2 / (eigs**2).sum())


def _cumulative_variance(eigs: np.ndarray) -> np.ndarray:
    total = eigs.sum()
    if total == 0:
        return np.zeros_like(eigs)
    return np.cumsum(eigs / total)


def _n_components(eigs: np.ndarray, threshold: float) -> int:
    # np.searchsorted(cumvar, threshold) + 1 on the sorted curve
    return int((_cumulative_variance(eigs) < threshold).sum() + 1)


def participation_ratio(x, device=None) -> float:
    """(Σλ)² / Σλ²: effective dimensionality."""
    return _participation_ratio(eigenspectrum(x, device))


def cumulative_variance(x, device=None) -> np.ndarray:
    """Cumulative variance-explained fractions."""
    return _cumulative_variance(eigenspectrum(x, device))


def n_components_for_variance(x, threshold: float = 0.9, device=None) -> int:
    """Components needed to explain ``threshold`` of the variance."""
    return _n_components(eigenspectrum(x, device), threshold)


def _two_nn_distances(x: torch.Tensor):
    """Squared-distance matrix → (r1, r2) nearest-neighbour distances
    (the Gram formula leaves each self-distance near 0: it is the
    smallest of the three kept per row, as in the JAX program)."""
    x = x - x.mean(dim=0)
    sq = (x * x).sum(dim=1)
    d2 = (sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)).clamp_min(0.0)
    d_sorted = torch.topk(d2, 3, dim=1, largest=False).values.sqrt()
    return d_sorted[:, 1], d_sorted[:, 2]


def two_nn_dimension(x, n_samples: int | None = None, seed: int = 42, device=None):
    """Facco Two-NN intrinsic dimension MLE and its bootstrap standard
    error: numpy's ``default_rng(seed)`` subsample (rows picked on the
    host), validity filters, 100-resample bootstrap."""
    device = input_device(x, device)
    rng = np.random.default_rng(seed)
    n_rows = x.shape[0]
    if n_samples is not None and n_rows > n_samples:
        idx = rng.choice(n_rows, n_samples, replace=False)
        x = (x[torch.as_tensor(idx, device=x.device)] if isinstance(x, torch.Tensor)
             else np.asarray(x)[idx])
    r1, r2 = (v.cpu().numpy() for v in _two_nn_distances(_f32(x, device)))
    valid = r1 > 1e-10
    mu = r2[valid] / r1[valid]
    mu = mu[mu >= 1.0]
    if len(mu) < 10:
        return np.nan, np.nan

    log_mu = np.log(mu)
    n = len(mu)
    dimension = n / log_mu.sum()
    boot_idx = rng.choice(n, (100, n), replace=True)
    boot_dims = n / log_mu[boot_idx].sum(axis=1)
    return float(dimension), float(np.std(boot_dims))


def _hoyer_impl(x: torch.Tensor) -> torch.Tensor:
    sqrt_n = torch.sqrt(torch.tensor(float(x.shape[1]), dtype=torch.float32, device=x.device))
    x_abs = x.abs()
    l1 = x_abs.sum(dim=1)
    l2 = torch.sqrt((x_abs * x_abs).sum(dim=1))
    s = (sqrt_n - l1 / l2.clamp_min(1e-30)) / (sqrt_n - 1.0)
    return torch.where(l2 < 1e-10, torch.ones_like(s), s)


def hoyer_sparsity(x, device=None) -> np.ndarray:
    """Per-sample Hoyer sparsity in [0, 1]."""
    return _hoyer_impl(_f32(x, device)).cpu().numpy()


def fraction_active(x, threshold: float = 0.0, device=None) -> np.ndarray:
    """Per-sample fraction of units with |a| > threshold."""
    return (_f32(x, device).abs() > threshold).to(torch.float32).mean(dim=1).cpu().numpy()


def compute_all_metrics(feats_dict: dict, layers, n_samples_twonn: int = 2000,
                        device=None) -> dict:
    """Every metric per layer: {"pr", "n90", "twonn", "sparsity",
    "eigenvalues"}, each {layer: ...}, as the JAX function returns them.
    One eigendecomposition per layer serves the participation ratio, the
    90 % count and the spectrum."""
    results = {"pr": {}, "n90": {}, "twonn": {}, "sparsity": {}, "eigenvalues": {}}
    for layer in layers:
        x = _f32(feats_dict[layer], device)
        x = x.reshape(x.shape[0], -1)
        eigs = _eigenspectrum_impl(x).cpu().numpy()
        results["pr"][layer] = _participation_ratio(eigs)
        results["n90"][layer] = _n_components(eigs, 0.9)
        dim, std = two_nn_dimension(x, n_samples=n_samples_twonn)
        results["twonn"][layer] = {"dimension": dim, "std": std}
        sparsity_vals = _hoyer_impl(x).cpu().numpy()
        results["sparsity"][layer] = {
            "mean": float(np.mean(sparsity_vals)),
            "std": float(np.std(sparsity_vals)),
            "frac_active": float(np.mean(fraction_active(x))),
        }
        results["eigenvalues"][layer] = eigs
    return results
