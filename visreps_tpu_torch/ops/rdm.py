"""Correlation RDMs and their comparison (port of
``visreps_tpu/ops/rdm.py``).

``compute_rdm`` keeps every detail of the JAX recipe: row centring, the
1e-12 variance stabiliser, the zero-variance guard (std < 10·correction
→ 1), cov / (std_i·std_j + correction), clamp to [−1, 1], unit diagonal,
1 − corr. The Gram product and that epilogue run in one call of
``ops/rdm_kernel.rdm_from_centered``: the hand-written Hopper kernel on
CUDA tensors, its plain torch version on CPU tensors. ``compute_rdm_correlation(_batched)``
correlate upper triangles: Spearman with average tie ranks (scipy's),
its dense-rank Σd² form, Pearson, or Kendall tau-a (batched over the
pairs in one ``kendall_tau_a`` call).
"""
from __future__ import annotations

import torch

from visreps_tpu_torch.ops.rdm_kernel import rdm_from_centered
from visreps_tpu_torch.ops.stats import (
    kendall_tau_a,
    pearson_corr,
    rankdata_dense,
    spearman_corr,
    spearman_corr_dense,
)

# Elements of x·x made at once for the row variances (1 GB of f32): at
# (1000, 3,211,264), VGG16's conv1 exact tap, the whole square would be
# a third 12.8 GB copy beside the input and its centred copy.
_SQUARE_ELEMS = 2**28


def compute_rdm(representations: torch.Tensor, correlation: str = "pearson",
                correction: float = 1e-12) -> torch.Tensor:
    """(n, d) activations → (n, n) float32 dissimilarity matrix 1 − corr.

    Diagonal 0, off-diagonals in [0, 2]. ``correlation`` is "pearson" or
    "spearman" (dense row ranks). The result lies on the input's device.
    """
    corr_name = correlation.lower()
    if corr_name not in {"pearson", "spearman"}:
        raise ValueError("correlation must be 'Pearson' or 'Spearman'")
    x = representations.to(torch.float32)
    if corr_name == "spearman":
        x = rankdata_dense(x, dim=1)
    x = x - x.mean(dim=1, keepdim=True)
    rows = max(1, _SQUARE_ELEMS // max(x.shape[1], 1))
    if x.shape[0] <= rows:
        var = (x * x).mean(dim=1)
    else:  # wide rows: the squares' temporary a block of rows at a time
        var = torch.cat([(c * c).mean(dim=1) for c in x.split(rows)])
    std = torch.sqrt(var + correction)
    std = torch.where(std < correction * 10, torch.ones_like(std), std)
    return rdm_from_centered(x.contiguous(), std.contiguous(), correction)


def triu_indices(n: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Strict upper-triangle (row, col) indices in row-major order —
    the order of ``np.triu_indices(n, k=1)``."""
    iu = torch.triu_indices(n, n, offset=1, device=device)
    return iu[0], iu[1]


def index_sets(indices, device) -> torch.Tensor:
    """(B, m_sub) stimulus index sets (array or tensor) as an int64 tensor
    on ``device``."""
    idx = torch.as_tensor(indices).to(device, torch.int64)
    if idx.dim() != 2:
        raise ValueError(f"indices must be (B, m_sub), got shape {tuple(idx.shape)}")
    return idx


def selection_masks(ix: torch.Tensor, n: int, iu: torch.Tensor, ju: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """(c, m_sub) index sets over n stimuli → (c, M) 0/1 masks of the
    triangle pairs (iu, ju) whose two stimuli are both in the set."""
    included = torch.zeros((ix.shape[0], n), dtype=dtype, device=ix.device)
    included.scatter_(1, ix, 1)
    return included[:, iu] * included[:, ju]


def upper_triangle(rdm: torch.Tensor) -> torch.Tensor:
    """Vectorize the strict upper triangle of (..., n, n), row-major."""
    iu, ju = triu_indices(rdm.shape[-1], rdm.device)
    return rdm[..., iu, ju]


def triangle_tie_count(rdm: torch.Tensor) -> int:
    """Number of exactly-tied adjacent values in the sorted upper
    triangle (0 ⇒ dense-rank Spearman equals average-tie Spearman)."""
    s = torch.sort(upper_triangle(rdm)).values
    return int((s[1:] == s[:-1]).sum())


_CORR_FUNCS = {"pearson": pearson_corr, "spearman": spearman_corr,
               "spearman_dense": spearman_corr_dense, "kendall": kendall_tau_a}


def _corr_fn(correlation: str):
    corr = correlation.lower()
    if corr not in _CORR_FUNCS:
        raise ValueError("correlation must be 'Pearson', 'Spearman', or 'Kendall'")
    return _CORR_FUNCS[corr]


def compute_rdm_correlation(rdm1: torch.Tensor, rdm2: torch.Tensor,
                            correlation: str = "spearman") -> float:
    """Correlation of two (n, n) RDMs' upper triangles; NaN when it is
    undefined (n ≤ 1 or a constant triangle)."""
    if rdm1.shape != rdm2.shape or rdm1.dim() != 2:
        raise ValueError("RDMs must share the same 2-D shape")
    fn = _corr_fn(correlation)
    if rdm1.shape[0] <= 1:
        return float("nan")
    return float(fn(upper_triangle(rdm1), upper_triangle(rdm2.to(rdm1.device))))


def compute_rdm_correlation_batched(rdms1: torch.Tensor, rdms2: torch.Tensor,
                                    correlation: str = "spearman") -> torch.Tensor:
    """(P, n, n) × (P, n, n) → (P,) upper-triangle correlations, pair by
    pair on the RDMs' device."""
    if rdms1.shape != rdms2.shape or rdms1.dim() != 3:
        raise ValueError("RDM stacks must share the same (P, n, n) shape")
    fn = _corr_fn(correlation)
    iu, ju = triu_indices(rdms1.shape[-1], rdms1.device)
    rdms2 = rdms2.to(rdms1.device)
    if fn is kendall_tau_a:  # batched over the pairs
        return fn(rdms1[:, iu, ju], rdms2[:, iu, ju])
    return torch.stack([fn(a[iu, ju], b[iu, ju]) for a, b in zip(rdms1, rdms2)])
