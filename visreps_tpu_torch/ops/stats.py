"""Rank statistics and correlations on tensors.

Ports of ``visreps_tpu/ops/stats.py``. Ranks use
``torch.argsort(..., stable=True)`` where the JAX package uses
``jnp.argsort`` (stable): tie order decides dense ranks. Every function
works along the last axis and broadcasts over leading ones.

``kendall_tau_a`` is Knight's algorithm: sort by (x, then y), count the
tie pairs, and count the y-sequence's strict inversions in log₂P merge
rounds of a batched binary search (``torch.searchsorted`` over the
rounds' sorted blocks). Counts are int64 and the tau is combined in
float64, so it is exact up to its final f32 rounding (the JAX package
sums per-slot int32 counts in f32).
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


# ─────────────────────── Kendall tau-a ────────────────────────


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def lexsort2(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Order along the last axis that sorts by ``primary``, ties by
    ``secondary`` (``jnp.lexsort((secondary, primary))``): two stable
    argsorts, the secondary key first."""
    o1 = torch.argsort(secondary, dim=-1, stable=True)
    o2 = torch.argsort(torch.gather(primary, -1, o1), dim=-1, stable=True)
    return torch.gather(o1, -1, o2)


def _eq_prev(v: torch.Tensor) -> torch.Tensor:
    """v[..., i] == v[..., i−1], False at i = 0."""
    first = torch.zeros_like(v[..., :1], dtype=torch.bool)
    return torch.cat([first, v[..., 1:] == v[..., :-1]], dim=-1)


def _tie_pair_count(eq_prev: torch.Tensor) -> torch.Tensor:
    """Σ c·(c−1)/2 over the tie groups of a sorted order given its
    adjacency flags (int64): with a_i the start of element i's group,
    Σ_i (i − a_i) = Σ_groups Σ_{j<c} j."""
    idx = torch.arange(eq_prev.shape[-1], device=eq_prev.device)
    return (idx - _group_starts(eq_prev)).sum(-1)


def _count_inversions(y: torch.Tensor) -> torch.Tensor:
    """Strict inversions (i < j, y_i > y_j) along the last axis (int64).

    Merge rounds: at width w the (+inf-padded) sequence is a run of
    sorted blocks of width w; each right block's elements count the left
    block's elements above them (``w − searchsorted(L, r, right=True)``),
    then each pair of blocks is merged by a sort."""
    lead, n = y.shape[:-1], y.shape[-1]
    P = _next_pow2(max(n, 2))
    a = torch.full((*lead, P), float("inf"), dtype=torch.float32, device=y.device)
    a[..., :n] = y
    a = a.reshape(-1, P)
    total = torch.zeros(a.shape[0], dtype=torch.int64, device=y.device)
    w = 1
    while w < P:
        pairs = a.reshape(-1, 2, w)                              # (rows · blocks, L|R, w)
        below = torch.searchsorted(pairs[:, 0].contiguous(), pairs[:, 1].contiguous(),
                                   right=True)                   # #{l ≤ r} per r
        total += (w - below).reshape(a.shape[0], -1).sum(-1)
        a = torch.sort(pairs.reshape(-1, 2 * w), dim=-1).values.reshape(-1, P)
        w *= 2
    return total.reshape(lead)


def kendall_tau_a(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Kendall tau-a = (C − D) / n0 along the last axis, tie pairs counted
    as neither (scipy's tau-b converted to tau-a, as the reference does);
    leading axes are a batch. float32 out, NaN for fewer than 2 values.

    Sort by (x, then y); D = strict inversions of the y-sequence;
    C − D = n0 − t_x − t_y + t_xy − 2D."""
    x, y = torch.broadcast_tensors(x.to(torch.float32), y.to(torch.float32))
    n = x.shape[-1]
    order = lexsort2(x, y)
    xs = torch.gather(x, -1, order)
    ys = torch.gather(y, -1, order)
    eq_x = _eq_prev(xs)
    t_x = _tie_pair_count(eq_x)
    t_y = _tie_pair_count(_eq_prev(torch.sort(y, dim=-1).values))
    t_xy = _tie_pair_count(eq_x & _eq_prev(ys))  # joint ties: runs of equal (x, y)
    d = _count_inversions(ys)
    n0 = n * (n - 1) / 2.0
    c_minus_d = n0 - t_x.double() - t_y.double() + t_xy.double() - 2.0 * d.double()
    if n0 <= 0:
        return torch.full(c_minus_d.shape, float("nan"), dtype=torch.float32, device=x.device)
    return (c_minus_d / n0).to(torch.float32)
