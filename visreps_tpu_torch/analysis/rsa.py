"""RSA layer selection and the train/test RSA protocol (port of
``visreps_tpu/analysis/rsa.py:135-407``).

A subject's selection stimuli are shared across its regions (same
stimuli, different voxels), so the L model RDMs and their rank
transforms are computed once per subject and scored against all R
neural RDMs. Spearman uses dense ranks and the Σd² form by default, or
scipy's average-tie ranks with ``exact_ties``; Pearson correlates the
raw triangles; Kendall runs all R × L tau-a in one batched call.

``compute_rsa`` is the per-pair protocol the THINGS eval runs: layer
selection on the selection split (optionally a seeded ``n_select``
subsample), then the selected layer's test RDM (optionally re-extracted
at full resolution), its point score and bootstrap CIs. Spearman with a
bootstrap runs fused and average-tie exact; every other setting takes
the unfused route of the JAX package. ``concept_average_exact`` averages
per-image activations per concept on the host.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from visreps_tpu_torch.analysis.alignment import take_rows
from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.core.profiling import span
from visreps_tpu_torch.device import input_device
from visreps_tpu_torch.ops.bootstrap import (
    bootstrap_indices,
    bootstrap_rdm_correlation,
    percentile_ci,
    single_pair_scoring,
)
from visreps_tpu_torch.ops.rdm import compute_rdm, compute_rdm_correlation, upper_triangle
from visreps_tpu_torch.ops.stats import (
    kendall_tau_a,
    pearson_corr,
    rankdata_average,
    rankdata_dense,
)

#: Wall-clock seconds of the last compute_rsa call's steps, each its
#: span's: selection_s (``rsa.selection``), re_extract_s (with a
#: re-extraction; ``rsa.exact``) and point_score_s (``rsa.point_score``;
#: with the bootstrap where it ran fused, and then fused = 1.0; else
#: bootstrap_s, ``rsa.bootstrap``, follows).
LAST_RSA_TIMES: Dict[str, float] = {}


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
    if method == "kendall":
        R, L = tri_n.shape[0], tri.shape[0]
        return kendall_tau_a(tri[None].expand(R, -1, -1), tri_n[:, None].expand(-1, L, -1))
    if method != "spearman":
        raise ValueError("method must be 'pearson', 'spearman' or 'kendall'")
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
                      method: str = "spearman", exact_ties: bool = False,
                      sel_idx: np.ndarray | None = None) -> Dict[str, float]:
    """Score every layer's RDM against ONE neural response matrix:
    {layer: score}, in the order of ``acts``. With ``sel_idx`` only those
    rows (of every layer and of ``neural``) are scored."""
    names = list(acts)
    if sel_idx is not None:
        acts = {n: take_rows(acts[n], sel_idx) for n in names}
        neural = take_rows(neural, sel_idx)
    first = torch.as_tensor(acts[names[0]])
    neural_t = torch.as_tensor(neural).to(first.device, torch.float32)
    if neural_t.dim() > 2:
        neural_t = neural_t.reshape(neural_t.shape[0], -1)
    layer_acts = [torch.as_tensor(acts[n]).to(first.device) for n in names]
    vals = select_scores_multipair([a.reshape(a.shape[0], -1) for a in layer_acts],
                                   compute_rdm(neural_t)[None], method, exact_ties)[0]
    return {n: float(v) for n, v in zip(names, vals.cpu().tolist())}


def compute_rsa(cfg, selection, evaluation, n_select: int | None = None,
                bootstrap: bool = True, n_bootstrap: int = 1000, seed: int = 42,
                verbose: bool = False, re_extract_fn=None, device=None,
                mesh=None) -> List[Dict]:
    """Select the best layer on ``selection``, score it on
    ``evaluation`` (AlignmentData), with bootstrap CIs.

    One RandomState(seed) draws the ``n_select`` subsample (when it is
    below the selection size) and then CONTINUES into the bootstrap
    draws, as the reference does. ``re_extract_fn(layer, ids)`` returns
    the selected layer's test activations (full resolution); without it
    the evaluation split's own activations are scored. Spearman with a
    bootstrap runs fused (``single_pair_scoring``: both RDMs, the point
    score and the bootstrap, average-tie exact) unless
    ``bootstrap_exact_ties`` is false; otherwise the point score is
    ``compute_rdm_correlation`` of the two RDMs and the bootstrap
    ``bootstrap_rdm_correlation`` (for Spearman then by dense ranks: under
    "auto" or true it runs fused, so the JAX package's tie detection on
    this route is not needed). Scoring runs on ``device`` (default: where
    the test activations lie; arrays need ``device``). Under a multi-rank
    ``mesh`` the bootstrap iterations shard over its 'data' axis.
    Returns a one-element list: layer, compare_method, score, ci_low,
    ci_high, analysis, layer_selection_scores and, with a bootstrap,
    bootstrap_scores and bootstrap_exact_ties.
    """
    method = cfg.get("compare_method", "spearman").lower()
    fused = (bootstrap and method == "spearman"
             and cfg.get("bootstrap_exact_ties", "auto") is not False)
    rng = np.random.RandomState(seed)
    n_train = selection.neural.shape[0]
    n_test = evaluation.neural.shape[0]
    if n_select is not None and n_select < n_train:
        sel_idx = rng.choice(n_train, size=n_select, replace=False)
        sel_label = f"subsampling {n_select}"
    else:
        sel_idx = np.arange(n_train)
        sel_label = f"using all {n_train}"
    if verbose:
        rprint(f"Train/test RSA: {n_train} train, {n_test} test, {sel_label} for layer selection",
               style="info")

    # ── 1. Layer selection ──
    LAST_RSA_TIMES.clear()
    with span("rsa.selection") as step:
        scores = select_best_layer(selection.activations, selection.neural, method,
                                   bool(cfg.get("selection_exact_ties", False)), sel_idx)
    LAST_RSA_TIMES["selection_s"] = step.seconds
    selection_scores = [{"layer": l, "score": s} for l, s in scores.items()]
    best_layer = max(scores, key=lambda l: scores[l] if scores[l] == scores[l] else -np.inf)
    if verbose:
        for l, s in scores.items():
            rprint(f"  [select] {l:<15} RSA = {s:.4f}", style="info")
        rprint(f"  Best layer: {best_layer} (score={scores[best_layer]:.4f})", style="highlight")

    # ── 2. Test activations (optionally re-extracted at full resolution) ──
    if re_extract_fn is not None:
        with span("rsa.exact") as step:
            rprint(f"  Re-extracting {best_layer} without SRP for exact test RDMs...",
                   style="info")
            test_acts, _ = re_extract_fn(best_layer, evaluation.stimulus_ids)
        LAST_RSA_TIMES["re_extract_s"] = step.seconds
    else:
        test_acts = evaluation.activations[best_layer]

    ci_low = ci_high = boot = None
    boot_exact = False
    with span("rsa.point_score") as step:
        device = input_device(test_acts, device)
        test_acts = torch.as_tensor(test_acts).to(device)
        test_acts = test_acts.reshape(test_acts.shape[0], -1)
        if fused:
            boot, point = single_pair_scoring(test_acts, evaluation.neural,
                                              bootstrap_indices(n_test, n_bootstrap, seed=rng),
                                              device=device, mesh=mesh)
            boot_exact = True
            LAST_RSA_TIMES["fused"] = 1.0
        else:
            neural_rdm = compute_rdm(torch.as_tensor(evaluation.neural).to(device, torch.float32))
            model_rdm = compute_rdm(test_acts)
            point = compute_rdm_correlation(model_rdm, neural_rdm, correlation=method)
    LAST_RSA_TIMES["point_score_s"] = step.seconds
    if not fused:
        with span("rsa.bootstrap") as step:
            if bootstrap:
                boot = bootstrap_rdm_correlation(
                    model_rdm, neural_rdm, method=method,
                    indices=bootstrap_indices(n_test, n_bootstrap, seed=rng), mesh=mesh)
        LAST_RSA_TIMES["bootstrap_s"] = step.seconds

    msg = f"  {method.capitalize():<10}| {best_layer} = {point:.4f}"
    if boot is not None:
        ci_low, ci_high = percentile_ci(boot)
        msg += f"  [95% CI: {ci_low:.4f}, {ci_high:.4f}]"
    rprint(msg, style="highlight")
    result = {
        "layer": best_layer,
        "compare_method": method,
        "score": point,
        "ci_low": ci_low,
        "ci_high": ci_high,
        "analysis": "rsa",
        "layer_selection_scores": selection_scores,
    }
    if boot is not None:
        result["bootstrap_scores"] = boot.tolist()
        result["bootstrap_exact_ties"] = boot_exact
    return [result]


def concept_average_exact(raw_acts: np.ndarray, raw_ids, data) -> np.ndarray:
    """Per-concept means of per-image activations, in ``data``'s concept
    order (``data.stimulus_ids``, images from ``data.concept_image_ids``;
    a concept with no image gets a zero row). Means are taken in float32
    and returned in the input's dtype."""
    raw_acts = np.asarray(raw_acts)
    id_to_idx = {str(k): i for i, k in enumerate(raw_ids)}
    out = []
    for concept in data.stimulus_ids:
        idx = [id_to_idx[sid] for sid in data.concept_image_ids[concept] if sid in id_to_idx]
        if idx:
            out.append(raw_acts[np.asarray(idx)].astype(np.float32).mean(axis=0))
        else:
            out.append(np.zeros(raw_acts.shape[1], np.float32))
    return np.stack(out).astype(raw_acts.dtype)
