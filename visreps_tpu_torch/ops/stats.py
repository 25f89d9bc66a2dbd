"""Rank statistics and correlations on tensors.

Ports of ``visreps_tpu/ops/stats.py:27-91``. Ranks use
``torch.argsort(..., stable=True)`` where the JAX package uses
``jnp.argsort`` (stable): tie order decides dense ranks. Every function
works along the last axis and broadcasts over leading ones.
"""
from __future__ import annotations

import torch


def rankdata_dense(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Dense ranking via double argsort (ties get consecutive ranks,
    first occurrence first). Ranks start at 0; float32 out."""
    order = torch.argsort(x, dim=dim, stable=True)
    return torch.argsort(order, dim=dim, stable=True).to(torch.float32)


def _group_starts(eq_prev: torch.Tensor) -> torch.Tensor:
    """Position of each element's tie-group start in a sorted order.

    eq_prev[..., i] is True when element i equals element i-1 (False at
    i = 0). One running max (``visreps_tpu/ops/kendall.py:57``).
    """
    idx = torch.arange(eq_prev.shape[-1], device=eq_prev.device).expand_as(eq_prev)
    return torch.cummax(torch.where(eq_prev, torch.zeros_like(idx), idx), dim=-1).values


def tie_groups(v: torch.Tensor):
    """Sorted order of ``v`` along its last axis plus, per sorted slot,
    the first and last slot of its tie group.

    Returns (order, pos, gs, ge): ``order`` sorts v, ``pos`` is its
    inverse (each element's sorted slot), ``gs``/``ge`` the tie-group
    bounds. The average rank (1-based) of every element is
    ``((gs + ge) / 2 + 1)[pos]``.
    """
    m = v.shape[-1]
    order = torch.argsort(v, dim=-1, stable=True)
    pos = torch.argsort(order, dim=-1, stable=True)
    sv = torch.gather(v, -1, order)
    first = torch.zeros_like(sv[..., :1], dtype=torch.bool)
    eq = torch.cat([first, sv[..., 1:] == sv[..., :-1]], dim=-1)
    gs = _group_starts(eq)
    # Group ends from group starts of the reversed order: the reversed
    # adjacency flags are eq[1:] reversed, not eq reversed.
    eq_rev = torch.cat([first, torch.flip(eq[..., 1:], dims=[-1])], dim=-1)
    ge = (m - 1) - torch.flip(_group_starts(eq_rev), dims=[-1])
    return order, pos, gs, ge


def rankdata_average(x: torch.Tensor) -> torch.Tensor:
    """scipy-compatible average ranks (1-based) along the last axis."""
    _, pos, gs, ge = tie_groups(x)
    avg_sorted = (gs + ge).to(torch.float32) / 2.0 + 1.0
    return torch.gather(avg_sorted, -1, pos)


def pearson_corr(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pearson correlation along the last axis (float32; NaN when a
    side has zero variance)."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    xc = x - x.mean(dim=-1, keepdim=True)
    yc = y - y.mean(dim=-1, keepdim=True)
    denom = torch.sqrt((xc * xc).sum(-1) * (yc * yc).sum(-1))
    num = (xc * yc).sum(-1)
    return torch.where(denom > 0, num / denom, torch.full_like(num, float("nan")))


def spearman_corr(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Spearman rho with scipy-style average tie ranks."""
    return pearson_corr(rankdata_average(x), rankdata_average(y))


def spearman_corr_dense(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Spearman rho via dense (tie-broken) ranks and the Σd² formula:
    rho = 1 − 6·Σd² / (n(n²−1)). Equal to scipy on distinct values."""
    n = float(x.shape[-1])
    d2 = ((rankdata_dense(x) - rankdata_dense(y)) ** 2).sum(-1)
    return 1.0 - 6.0 * d2 / (n * (n * n - 1.0))
