"""Kendall tau-a bootstrap as three batched contractions (port of
``visreps_tpu/ops/kendall.py``).

Every bootstrap iteration's pairs are a subset of the full RDM triangle,
so the ordering structure is computed once per (model, neural) pair and
each iteration reduces to masked pair counts.

Let lex = sort by (x, then y) and σ = the stable argsort of y over the
lex arrangement. Within an x-tie group y ascends, and within a y-tie
group σ keeps lex order, so the discordant count is a pure
two-permutation inversion count,

    D = #{pairs: lexpos_i < lexpos_j and σpos_i > σpos_j},

split over position blocks of width ``block`` (1024 by default):

  1. same lex block          → mᵀ A m per block, A the in-block
                                inversion indicator;
  2. same y block, other lex  → the same over the σ arrangement with A2;
  3. different both           → a quadratic form over the (lex block,
                                y block) joint histogram J = Eᵀ m.

The tie terms t_x, t_y, t_xy (exact tau-a, scipy's tau-b converted) come
from exclusive prefix counts of the masks read at each tie group's start.

Arithmetic: the contractions run on f32 0/1 operands with TF32 off
(``device.resolve_device``); each of their sums is an integer below 2²⁴,
so they are exact. Sums that can pass 2²⁴ (the prefix counts, the tie
and discordant totals) run in float64, so the tau is exact up to its
final f32 rounding. The JAX package contracts in bf16 with f32
accumulation and takes its exclusive prefixes as a strict-lower-
triangular matmul (for the MXU); here they are a cumulative sum.
"""
from __future__ import annotations

import torch

from visreps_tpu_torch.ops.rdm import index_sets, selection_masks, triu_indices
from visreps_tpu_torch.ops.stats import _eq_prev, _group_starts, _next_pow2, lexsort2

BLOCK = 1024  # position-block width of the contractions


def kendall_precompute(va: torch.Tensor, vb: torch.Tensor, block: int = BLOCK) -> dict:
    """The static ordering structure of two (M,) triangle vectors: the
    mask permutations (lex and y-stable), the tie-group starts and the
    contraction operands A, A2 (nb, B, B) and E (nb, B, nb)."""
    M = int(va.shape[0])
    P = _next_pow2(max(M, 2))
    B = min(block, P)
    nb = P // B
    dev = va.device
    va = va.to(torch.float32)
    vb = vb.to(torch.float32)

    order0 = lexsort2(va, vb)
    xs, ys = va[order0], vb[order0]
    y_pad = torch.cat([ys, torch.full((P - M,), float("inf"), device=dev)])
    # lex position → triangle slot (pad positions read the zero pad rows)
    perm0 = torch.cat([order0, torch.arange(M, P, device=dev)])
    sigma = torch.argsort(y_pad, stable=True)     # y position → lex slot (pads last)
    spos = torch.empty_like(sigma)
    spos[sigma] = torch.arange(P, device=dev)     # lex slot → y position
    perm_y = perm0[sigma]                         # y position → triangle slot

    pad = torch.zeros(P - M, dtype=torch.bool, device=dev)
    eq_x = _eq_prev(xs)
    sg_x = _group_starts(torch.cat([eq_x, pad]))
    sg_xy = _group_starts(torch.cat([eq_x & _eq_prev(ys), pad]))
    ysorted = y_pad[sigma]
    eq_y = _eq_prev(ysorted) & torch.isfinite(ysorted)  # each pad its own group
    sg_y = _group_starts(eq_y)

    iu = torch.arange(B, device=dev)
    i_lt_j = iu[:, None] < iu[None, :]
    sp = spos.reshape(nb, B)
    # (1) in-lex-block inversions: lex order ascending, y position descending
    A = ((sp[:, :, None] > sp[:, None, :]) & i_lt_j).to(torch.float32)
    # (2) in-y-block, across lex blocks: the later y position from a
    # strictly earlier lex block
    lexblk = (sigma // B).reshape(nb, B)
    A2 = ((lexblk[:, None, :] < lexblk[:, :, None]) & i_lt_j).to(torch.float32)
    # (3) one-hot of each lex slot's y block
    yblk = (spos // B).reshape(nb, B)
    E = (yblk[:, :, None] == torch.arange(nb, device=dev)).to(torch.float32)
    return {"P": P, "M": M, "B": B, "nb": nb, "perm0": perm0, "perm_y": perm_y,
            "sg_x": sg_x, "sg_xy": sg_xy, "sg_y": sg_y, "A": A, "A2": A2, "E": E}


def _excl_prefix(m: torch.Tensor) -> torch.Tensor:
    """(c, P) 0/1 masks → float64 exclusive prefix counts along P (a scan
    along the contiguous axis: along the outer axis the scan is one
    sequential walk of P steps per column)."""
    m = m.to(torch.float64)
    return torch.cumsum(m, dim=1) - m


def _tie_pairs(m: torch.Tensor, exc: torch.Tensor, sg: torch.Tensor) -> torch.Tensor:
    """Selected pairs inside each tie group: Σ m · (selected before the
    element in its group), per row."""
    return (m.to(torch.float64) * (exc - exc[:, sg])).sum(1)


def _in_block_inversions(A: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Σ_b m_bᵀ A_b m_b per index set (float64), with m as (nb, c, B):
    (m Aᵀ)[b, c, i] = Σ_j A[b, i, j] m[b, c, j]. Every per-block sum is an
    integer ≤ B², exact in f32."""
    return (m * torch.bmm(m, A.transpose(1, 2))).sum(2).to(torch.float64).sum(0)


def _chunk_scores(pre: dict, ix: torch.Tensor, n: int, iu: torch.Tensor,
                  ju: torch.Tensor) -> torch.Tensor:
    """(c, m_sub) index sets → (c,) f32 tau-a of each sub-triangle."""
    P, M, B, nb = pre["P"], pre["M"], pre["B"], pre["nb"]
    c, m_sub = ix.shape
    maskp = torch.zeros((c, P), dtype=torch.float32, device=ix.device)
    maskp[:, :M] = selection_masks(ix, n, iu, ju)
    m_lex = maskp[:, pre["perm0"]]                                       # (c, P)
    m_y = maskp[:, pre["perm_y"]]
    del maskp

    exc = _excl_prefix(m_lex)
    t_x = _tie_pairs(m_lex, exc, pre["sg_x"])
    t_xy = _tie_pairs(m_lex, exc, pre["sg_xy"])
    exc = _excl_prefix(m_y)
    t_y = _tie_pairs(m_y, exc, pre["sg_y"])
    del exc

    m_lex = m_lex.reshape(c, nb, B).transpose(0, 1)                      # (nb, c, B)
    m_y = m_y.reshape(c, nb, B).transpose(0, 1)
    D = _in_block_inversions(pre["A"], m_lex) + _in_block_inversions(pre["A2"], m_y)
    # (3) J[p, :, s] = selected elements of lex block p in y block s (≤ B)
    J = torch.bmm(m_lex, pre["E"]).to(torch.float64)                     # (nb, c, nb)
    Jp = torch.cumsum(J, dim=0) - J                                      # Σ_{p<q}
    G = torch.flip(torch.cumsum(torch.flip(Jp, dims=[2]), dim=2), dims=[2]) - Jp  # Σ_{s>t}
    D = D + (G * J).sum((0, 2))

    m_pairs = m_sub * (m_sub - 1) // 2
    n0 = m_pairs * (m_pairs - 1) / 2.0
    if n0 <= 0:
        return torch.full((c,), float("nan"), dtype=torch.float32, device=ix.device)
    return ((n0 - t_x - t_y + t_xy - 2.0 * D) / n0).to(torch.float32)


def bootstrap_kendall_fast(rdm_a: torch.Tensor, rdm_b: torch.Tensor, idx, chunk: int = 250,
                           block: int = BLOCK) -> torch.Tensor:
    """(B,) f32 Kendall tau-a of each (m_sub,) index set's sub-RDM
    triangles, ``chunk`` index sets at a time, on the RDMs' device; equal
    to gathering each sub-triangle and calling ``stats.kendall_tau_a``
    (tau does not depend on pair order, and ties are handled exactly)."""
    n = rdm_a.shape[0]
    iu, ju = triu_indices(n, rdm_a.device)
    pre = kendall_precompute(rdm_a[iu, ju], rdm_b.to(rdm_a.device)[iu, ju], block)
    idx = index_sets(idx, rdm_a.device)
    parts = [_chunk_scores(pre, idx[s:s + chunk], n, iu, ju)
             for s in range(0, idx.shape[0], max(1, chunk))]
    return torch.cat(parts) if parts else torch.zeros(0, device=rdm_a.device)
