"""Phase-1 layer selection (port of ``visreps_tpu/analysis/rsa.py:135-228``).

A subject's selection stimuli are shared across its regions (same
stimuli, different voxels), so the L model RDMs and their rank
transforms are computed once per subject and scored against all R
neural RDMs. Spearman uses dense ranks and the Σd² form by default, or
scipy's average-tie ranks with ``exact_ties``; Pearson correlates the
raw triangles.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from visreps_tpu_torch.ops.rdm import compute_rdm, upper_triangle
from visreps_tpu_torch.ops.stats import pearson_corr, rankdata_average, rankdata_dense


def select_scores_multipair(layer_acts: Sequence[torch.Tensor], neural_rdms: torch.Tensor,
                            method: str = "spearman", exact_ties: bool = False) -> torch.Tensor:
    """L (n, d_l) layer activations + (R, n, n) neural RDMs → (R, L)
    RDM-comparison scores. Widths may differ across layers."""
    method = method.lower()
    tri = torch.stack([upper_triangle(compute_rdm(a)) for a in layer_acts])  # (L, M)
    tri_n = upper_triangle(neural_rdms.to(tri.device))                       # (R, M)
    if method == "pearson":
        xc = tri - tri.mean(dim=1, keepdim=True)
        yc = tri_n - tri_n.mean(dim=1, keepdim=True)
        denom = torch.sqrt((yc * yc).sum(1)[:, None] * (xc * xc).sum(1)[None, :])
        return (yc @ xc.T) / denom
    if method != "spearman":
        raise NotImplementedError(
            f"compare_method={method!r} selection is not ported yet "
            "(ROADMAP.md, 'Pearson/Kendall scoring')")
    if exact_ties:
        rx = rankdata_average(tri)
        ry = rankdata_average(tri_n)
        return pearson_corr(rx[None, :, :], ry[:, None, :])
    rx = rankdata_dense(tri)
    ry = rankdata_dense(tri_n)
    m = float(tri.shape[1])
    d2 = ((rx[None, :, :] - ry[:, None, :]) ** 2).sum(-1)
    return 1.0 - 6.0 * d2 / (m * (m * m - 1.0))


def select_best_layer(acts: Dict[str, torch.Tensor], neural: np.ndarray | torch.Tensor,
                      method: str = "spearman", exact_ties: bool = False) -> Dict[str, float]:
    """Score every layer's RDM against ONE neural response matrix:
    {layer: score}, in the order of ``acts``."""
    names = list(acts)
    first = acts[names[0]]
    neural_t = torch.as_tensor(np.asarray(neural, np.float32), device=first.device)
    if neural_t.dim() > 2:
        neural_t = neural_t.reshape(neural_t.shape[0], -1)
    vals = select_scores_multipair([acts[n] for n in names], compute_rdm(neural_t)[None],
                                   method, exact_ties)[0]
    return {n: float(v) for n, v in zip(names, vals.cpu().tolist())}
