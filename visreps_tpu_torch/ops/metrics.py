"""Batched correlation / similarity metrics (port of
``visreps_tpu/ops/metrics.py``).

``pearson_r``, ``spearman_r`` and ``covariance`` with optional leading
batch dims, Bessel's correction and diagonal-or-matrix output; R²; linear
CKA through HSIC. Samples lie along axis −2 (a 1-D input is one column).
Spearman ranks are ordinal, by a stable double argsort as ``jnp.argsort``
gives them: tied values take consecutive ranks in input order. Inputs are
tensors (the result on their device) or arrays (the result on the CPU);
everything runs in float32.
"""
from __future__ import annotations

import torch


def _prep(x) -> torch.Tensor:
    x = torch.as_tensor(x).to(torch.float32)
    if x.dim() not in (1, 2, 3):
        raise ValueError(f"x must have 1, 2 or 3 dimensions (n_dim = {x.dim()})")
    return x[:, None] if x.dim() == 1 else x


def _ranks(x: torch.Tensor) -> torch.Tensor:
    order = torch.argsort(x, dim=-2, stable=True)
    return torch.argsort(order, dim=-2, stable=True).to(torch.float32)


def _helper(x, y, *, center, scale, correction=1, return_diagonal=True,
            replace_with_ranks=False):
    x = _prep(x)
    n_samples = x.shape[-2]
    if replace_with_ranks:
        x = _ranks(x)
    if y is not None:
        y = _prep(y).to(x.device)
        if y.shape[-2] != n_samples:
            raise ValueError("x and y must have same n_samples")
        if return_diagonal and x.shape[-1] != y.shape[-1]:
            raise ValueError("x and y must have same n_features to return diagonal")
        if replace_with_ranks:
            y = _ranks(y)
    else:
        y = x
    if center:
        x = x - x.mean(dim=-2, keepdim=True)
        y = y - y.mean(dim=-2, keepdim=True)
    if scale:
        x = x / x.std(dim=-2, keepdim=True, correction=correction)
        y = y / y.std(dim=-2, keepdim=True, correction=correction)
    denom = n_samples - correction if correction else n_samples
    if return_diagonal:
        out = (x * y).sum(dim=-2) / denom
    else:
        out = x.transpose(-2, -1) @ y / denom
    return out.squeeze()


def pearson_r(x, y=None, *, return_diagonal=True, correction=1):
    return _helper(x, y, center=True, scale=True, correction=correction,
                   return_diagonal=return_diagonal)


def spearman_r(x, y=None, *, return_diagonal=True, correction=1):
    return _helper(x, y, center=True, scale=True, correction=correction,
                   return_diagonal=return_diagonal, replace_with_ranks=True)


def covariance(x, y=None, *, return_diagonal=True, correction=1):
    return _helper(x, y, center=True, scale=False, correction=correction,
                   return_diagonal=return_diagonal)


def r2_score(y, y_predicted) -> torch.Tensor:
    """R² = 1 − Σ(y − ŷ)² / Σ(y − ȳ)² per column; a zero-variance column
    divides by 1."""
    y = _prep(y)
    y_predicted = _prep(y_predicted).to(y.device)
    sse = ((y - y_predicted) ** 2).sum(dim=-2)
    ss = ((y - y.mean(dim=-2, keepdim=True)) ** 2).sum(dim=-2)
    return 1.0 - sse / torch.where(ss == 0, torch.ones_like(ss), ss)


def linear_kernel(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x @ y.transpose(-2, -1)


def hsic(k_x: torch.Tensor, k_y: torch.Tensor) -> torch.Tensor:
    n = k_x.shape[0]
    h = torch.eye(n, device=k_x.device) - torch.full((n, n), 1.0 / n, device=k_x.device)
    return torch.trace((k_x @ h) @ (k_y @ h)) / ((n - 1) ** 2)


def cka(x, y, kernel=linear_kernel) -> torch.Tensor:
    x = torch.as_tensor(x).to(torch.float32)
    y = torch.as_tensor(y).to(x.device, torch.float32)
    k_x, k_y = kernel(x, x), kernel(y, y)
    return hsic(k_x, k_y) / torch.sqrt(hsic(k_x, k_x) * hsic(k_y, k_y))
