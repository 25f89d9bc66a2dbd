"""PCA fit, transform, inverse transform and low-rank reconstruction
(port of ``visreps_tpu/ops/pca.py``).

The reference fits sklearn's PCA and round-trips transform →
inverse_transform (visreps/analysis/reconstruct_from_pcs.py); the JAX
package takes an economy SVD of the centred matrix. The reconstruction
depends only on the top-k subspace, which ``fit_pca`` takes from a
float64 eigh of the smaller Gram matrix of the centred rows: the n × n
Gram X Xᵀ where n ≤ d (the evals' exact taps: 1,000 stimuli against up
to 3.2 M features), the d × d covariance otherwise. On the H100, at the
(1000, 193,600) exact tap whose top eigenvalues lie within 0.22 % of
each other, the f32 SVD's default cuSOLVER route (gesvdj) rebuilt the
rank-1 reconstruction 1.6e-3 (of its largest value) away from an f64
reference, LAPACK's f32 SVD 7.5e-5, the f64 SVD 3.6e-8; the f64 Gram
eigh took 25 ms against the SVD's 140 ms and needs no (n, d) copy
(``chip_smoke.py`` pca phase).
"""
from __future__ import annotations

from dataclasses import dataclass
from itertools import chain

import numpy as np
import torch

from visreps_tpu_torch.device import input_device


@dataclass
class PCATransform:
    mean: torch.Tensor                # (d,)
    components: torch.Tensor          # (k, d)
    explained_variance: torch.Tensor  # (k,)

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) @ self.components.T

    def inverse_transform(self, z: torch.Tensor) -> torch.Tensor:
        return z @ self.components + self.mean

    def reconstruct(self, x: torch.Tensor) -> torch.Tensor:
        return self.inverse_transform(self.transform(x))


# Columns (or rows) of the centred matrix widened to f64 at a time.
_BLOCK = 1 << 18


def _gram64(xc: torch.Tensor, rows: bool) -> torch.Tensor:
    """float64 X Xᵀ (``rows``) or Xᵀ X of the f32 matrix, summed over
    blocks of its long side."""
    n, d = xc.shape
    size = n if rows else d
    g = torch.zeros((size, size), dtype=torch.float64, device=xc.device)
    for start in range(0, d if rows else n, _BLOCK):
        b = (xc[:, start:start + _BLOCK] if rows else xc[start:start + _BLOCK]).double()
        g += b @ b.T if rows else b.T @ b
    return g


def fit_pca(x: torch.Tensor, k: int) -> PCATransform:
    """Top-k PCA of (n, d) rows on ``x``'s device: the mean in float32,
    the components from a float64 eigh of the smaller Gram matrix of the
    centred rows (n × n when n ≤ d: component = Xᵀu / √λ; else the d × d
    covariance's eigenvectors), returned in float32 with variances
    λ / (n − 1). A direction whose eigenvalue is below the f64 roundoff of
    the largest gets a zero component (it holds none of the data)."""
    x = x.to(torch.float32)
    n, d = x.shape
    mean = x.mean(dim=0)
    xc = x - mean
    k = min(k, n, d)
    lam, vec = torch.linalg.eigh(_gram64(xc, rows=n <= d))
    lam, vec = lam.flip(0)[:k], vec.flip(1)[:, :k]
    if n <= d:
        live = lam > lam[0].abs() * max(n, d) * torch.finfo(torch.float64).eps
        scale = torch.where(live, lam.clamp_min(0).sqrt(), torch.ones_like(lam))
        comps = torch.cat([vec.T @ xc[:, s:s + _BLOCK].double() for s in range(0, d, _BLOCK)],
                          dim=1) / scale[:, None]
        comps = comps * live[:, None]
    else:
        comps = vec.T
    return PCATransform(mean=mean, components=comps.to(torch.float32),
                        explained_variance=(lam.clamp_min(0) / (n - 1)).to(torch.float32))


def reconstruct_from_pcs(acts: dict, k: int, device=None) -> dict:
    """Each layer's activations rebuilt from the top-k PCs of the matrix
    itself, flattened to (n, features) as the JAX package returns them,
    in the input's dtype, on ``device`` (default: where a tensor lies; an
    array needs ``device``). Tensors come back as tensors on that device,
    arrays as arrays."""
    out = {}
    for name, x in acts.items():
        if np.ndim(x) < 2:
            raise ValueError(f"{name}: need >=2-D array")
        as_array = not isinstance(x, torch.Tensor)
        t = torch.as_tensor(x).to(input_device(x, device))
        flat = t.reshape(t.shape[0], -1)
        pca = fit_pca(flat, min(k, flat.shape[1]))
        rec = pca.reconstruct(flat.to(torch.float32)).to(t.dtype)
        out[name] = rec.cpu().numpy() if as_array else rec
    return out


def fit_pca_covariance(x_batches, d: int, k: int, device=None):
    """Top-k eigenvectors of the covariance accumulated over (b, d)
    batches (arrays or tensors), in float32 on ``device`` (default: the
    first batch's; array batches need ``device``), as
    ``scripts/coarsegrain/compute_eigenvectors.py`` fits them.
    Returns (eigvecs (d, k), eigvals (k,), mean (d,), total variance)."""
    batches = iter(x_batches)
    first = next(batches)
    device = input_device(first, device)
    n = 0
    s1 = torch.zeros(d, dtype=torch.float32, device=device)
    s2 = torch.zeros((d, d), dtype=torch.float32, device=device)
    for xb in chain([first], batches):
        xb = torch.as_tensor(xb).to(device, torch.float32)
        n += xb.shape[0]
        s1 += xb.sum(dim=0)
        s2 += xb.T @ xb
    mean = s1 / n
    eigvals, eigvecs = torch.linalg.eigh(s2 / n - torch.outer(mean, mean))
    order = torch.argsort(eigvals, descending=True)[:k]
    return eigvecs[:, order], eigvals[order], mean, eigvals.sum()
