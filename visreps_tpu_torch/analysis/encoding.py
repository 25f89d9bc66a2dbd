"""Encoding score: voxelwise ridge prediction (port of
``visreps_tpu/analysis/encoding.py``).

Protocol of the reference (visreps/analysis/encoding_score.py:65-260):
alphas = logspace(−10, 10, 20), 5-fold CV, fit_intercept=False, fit-only
z-norm statistics, a seeded 80/20 fit/val split for layer selection,
metric = mean per-voxel Pearson r, bootstrap 1000 × 90 % over CACHED
test predictions (no refit). One ``RandomState(seed)`` draws the
permutation and then the bootstrap index sets, as the reference does.

The ridge work is ``ops/ridge.py``; every tensor lives on ``device``.
With ``reconstruct_pca_k`` the selected layer's train and test rows are
rebuilt from the top-k PCs of its train rows before the refit
(``ops/pca.py``), as the JAX package does.

Under a mesh (``mesh=``, the eval's row-sharded route) each rank holds
only its row block of every train and test array whose row count the
'data' axis divides (the JAX package's rule; others stay whole), and the
ridge sums, gathers and broadcasts over the 'data' ranks
(``ops/ridge.py``); every rank returns the same results.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.core.profiling import span
from visreps_tpu_torch.device import input_device
from visreps_tpu_torch.ops.bootstrap import percentile_ci
from visreps_tpu_torch.ops.pca import PCATransform, fit_pca
from visreps_tpu_torch.ops.ridge import (
    correlation_score,
    default_alphas,
    ridge_cv,
    ridge_cv_refit_predict,
    ridge_cv_refit_predict_grouped,
    ridge_cv_selection_val_r,
)
from visreps_tpu_torch.ops.znorm import znorm, znorm_fit
from visreps_tpu_torch.parallel.shard import RowBlocks

#: Wall-clock seconds of the last compute_encoding_scores_subjects call,
#: each its span's: selection_s (selection sweep, ``encoding.selection``),
#: refit_s (cross-subject refits, ``encoding.refit``),
#: assemble_bootstrap_s (per-region scores and bootstraps,
#: ``encoding.assemble_bootstrap``). This process's own under a mesh.
LAST_PHASE_TIMES: Dict[str, float] = {}


def _reconstructed(x_tr: torch.Tensor, x_te: torch.Tensor, k: int | None, rows=None):
    """Train and test rows rebuilt from the top-k PCs of the train rows
    (unchanged without ``k``). Under row blocks the PCs are fitted on the
    gathered train rows and taken from data rank 0, and each rank rebuilds
    its own rows."""
    if k is None:
        return x_tr, x_te
    pca = fit_pca(x_tr if rows is None else rows.cat(x_tr), min(k, x_tr.shape[1]))
    if rows is not None:
        pca = PCATransform(rows.share(pca.mean.contiguous(), 0),
                           rows.share(pca.components.contiguous(), 0), pca.explained_variance)
    return pca.reconstruct(x_tr), pca.reconstruct(x_te)


def _rows_here(rows) -> slice:
    """This rank's rows of an array laid out as ``rows`` (all without)."""
    return slice(None) if rows is None else rows.block()


def _flatten_f32(acts: Dict, device, rows=None) -> Dict[str, torch.Tensor]:
    """{layer: (n, ...) array or tensor} → {layer: (n, features) f32 tensor
    on device}, only this rank's block under ``rows``."""
    out = {}
    for l, a in acts.items():
        t = torch.as_tensor(a[_rows_here(rows)], device=device)
        out[l] = (t.reshape(t.shape[0], -1) if t.dim() > 2 else t).to(torch.float32)
    return out


def _bootstrap_pred_scores(y_true: torch.Tensor, pred: torch.Tensor, idx: torch.Tensor,
                           chunk: int = 64) -> torch.Tensor:
    """(B,) mean per-voxel Pearson r of each (B, m) index set's rows,
    ``chunk`` index sets at a time (a chunk gathers 2 × chunk × m × v f32)."""
    scores = []
    for start in range(0, idx.shape[0], chunk):
        ix = idx[start:start + chunk]
        yt, yp = y_true[ix], pred[ix]                          # (c, m, v)
        yt = yt - yt.mean(dim=1, keepdim=True)
        yp = yp - yp.mean(dim=1, keepdim=True)
        denom = torch.sqrt((yt * yt).sum(dim=1) * (yp * yp).sum(dim=1))
        r = torch.where(denom > 0, (yt * yp).sum(dim=1) / denom, 0.0)
        scores.append(r.mean(dim=1))
    return torch.cat(scores) if scores else torch.zeros(0, device=y_true.device)


def _boot_indices(rng: np.random.RandomState, n_test: int, n_bootstrap: int) -> np.ndarray:
    return np.stack([rng.choice(n_test, size=int(n_test * 0.9), replace=False)
                     for _ in range(n_bootstrap)]).astype(np.int32)


def _fit_and_score(x_tr, y_tr, x_te, y_te, alphas):
    """Fit RidgeCV on train, predict test, return (pred, mean Pearson r)."""
    pred = ridge_cv(x_tr, y_tr, alphas=alphas).predict(x_te)
    return pred, float(correlation_score(y_te, pred).mean())


def compute_encoding_score(selection, evaluation, bootstrap: bool = True,
                           n_bootstrap: int = 1000, seed: int = 42, verbose: bool = False,
                           reconstruct_pca_k: int | None = None, device=None) -> List[Dict]:
    """Select the best layer on train (80/20 fit/val), refit on the full
    train split, score test. Single-element list, the reference's
    contract; the inputs are not mutated."""
    device = input_device(next(iter(selection.activations.values())), device)
    rng = np.random.RandomState(seed)
    alphas = default_alphas()

    train_acts = _flatten_f32(selection.activations, device)
    test_acts = _flatten_f32(evaluation.activations, device)
    y_train_raw = torch.as_tensor(np.asarray(selection.neural, np.float32), device=device)
    y_test_raw = torch.as_tensor(np.asarray(evaluation.neural, np.float32), device=device)
    n_train, n_test = y_train_raw.shape[0], y_test_raw.shape[0]
    n_voxels = y_train_raw.shape[1]
    if verbose:
        rprint(f"Train/test encoding: {n_train} train, {n_test} test, {n_voxels} voxels",
               style="info")

    # ── 1. Layer selection on the seeded 80/20 fit/val split ──
    split = int(0.8 * n_train)
    perm = rng.permutation(n_train)
    fit_idx = torch.as_tensor(perm[:split], device=device)
    val_idx = torch.as_tensor(perm[split:], device=device)
    y_fit_normed, y_mean, y_std = znorm_fit(y_train_raw[fit_idx])
    y_val_normed = znorm(y_train_raw[val_idx], y_mean, y_std)

    pending = []
    for layer, acts in train_acts.items():
        x_fit_normed, x_mean, x_std = znorm_fit(acts[fit_idx])
        x_val_normed = znorm(acts[val_idx], x_mean, x_std)
        pred = ridge_cv(x_fit_normed, y_fit_normed, alphas=alphas).predict(x_val_normed)
        pending.append((layer, correlation_score(y_val_normed, pred).mean()))
    fetched = torch.stack([s for _, s in pending]).cpu().tolist()

    selection_scores = []
    best_layer, best_score = None, -float("inf")
    for (layer, _), score in zip(pending, fetched):
        selection_scores.append({"layer": layer, "score": score})
        if verbose:
            rprint(f"  [select] {layer:<15} r={score:.4f}  "
                   f"({train_acts[layer].shape[1]} features)", style="info")
        if score > best_score:
            best_score, best_layer = score, layer
    del pending
    if verbose:
        rprint(f"  Best layer: {best_layer} (val r={best_score:.4f}, "
               f"{train_acts[best_layer].shape[1]} features, {n_voxels} voxels)",
               style="highlight")

    # ── 1b. Optional train-fitted PCA reconstruction of the selected layer ──
    if reconstruct_pca_k is not None:
        rprint(f"  Reconstructing {best_layer} from {reconstruct_pca_k} PCs (train-fitted)",
               style="info")
    x_train_best, x_test_best = _reconstructed(train_acts[best_layer], test_acts[best_layer],
                                               reconstruct_pca_k)

    # ── 2. Refit on the FULL train split (full-train z-norm statistics) ──
    x_train_normed, x_mean, x_std = znorm_fit(x_train_best)
    x_test_normed = znorm(x_test_best, x_mean, x_std)
    y_train_normed, ym, ys = znorm_fit(y_train_raw)
    y_test_normed = znorm(y_test_raw, ym, ys)
    pred_test, point_estimate = _fit_and_score(
        x_train_normed, y_train_normed, x_test_normed, y_test_normed, alphas)
    if verbose:
        median_r = float(torch.quantile(correlation_score(y_test_normed, pred_test), 0.5))
        rprint(f"  Test encoding: mean r={point_estimate:.4f}, median r={median_r:.4f} "
               f"({n_voxels} voxels)", style="highlight")

    # ── 3. Bootstrap over cached predictions (the SAME RandomState) ──
    ci_low = ci_high = None
    bootstrap_scores_list = None
    if bootstrap:
        idx = torch.as_tensor(_boot_indices(rng, n_test, n_bootstrap), dtype=torch.long,
                              device=device)
        scores = _bootstrap_pred_scores(y_test_normed, pred_test, idx).cpu().numpy()
        scores = scores.astype(np.float64)
        ci_low, ci_high = percentile_ci(scores)
        bootstrap_scores_list = scores.tolist()

    msg = f"  Encoding  | {best_layer} = {point_estimate:.4f}"
    if bootstrap:
        msg += f"  [95% CI: {ci_low:.4f}, {ci_high:.4f}]"
    rprint(msg, style="highlight")
    result = {
        "layer": best_layer, "compare_method": "pearson", "score": point_estimate,
        "ci_low": ci_low, "ci_high": ci_high, "analysis": "encoding_score",
        "layer_selection_scores": selection_scores,
    }
    if bootstrap_scores_list is not None:
        result["bootstrap_scores"] = bootstrap_scores_list
    return [result]


def compute_encoding_scores_subject(acts_train: Dict, acts_test: Dict, y_train: Dict,
                                    y_test: Dict, bootstrap: bool = True,
                                    n_bootstrap: int = 1000, seed: int = 42,
                                    verbose: bool = False,
                                    reconstruct_pca_k: int | None = None,
                                    cv_precision: str = "highest", device=None,
                                    mesh=None, _defer: bool = False) -> Dict:
    """All-region encoding scores for ONE subject in one batched pass.

    Within a subject X is the same for every region (same stimuli), so:
    the regions' voxel blocks are concatenated into one Y (per-voxel alpha
    CV and Pearson scores are column-independent, so each region's numbers
    are those of its own fit); the layer selections run stacked, one
    ``ridge_cv_selection_val_r`` per layer width; and each UNIQUE selected
    layer is refit once, predicting all its regions' voxels together.
    The seeded split and bootstrap draws are those of a per-pair
    ``RandomState(seed)``. With ``mesh`` (a ``DeviceMesh`` whose 'data'
    ranks all call this) each rank holds and stacks only its row block of
    the inputs (whole arrays on every rank); every rank returns the same
    results. Returns {region: [result]}.
    """
    regions = list(y_train)
    device = input_device(next(iter(acts_train.values())), device)
    n_train, n_test = len(y_train[regions[0]]), len(y_test[regions[0]])
    rows, rows_te = RowBlocks.of(n_train, mesh), RowBlocks.of(n_test, mesh)
    train_f32 = _flatten_f32(acts_train, device, rows)
    test_f32 = _flatten_f32(acts_test, device, rows_te)
    y_train = {r: torch.as_tensor(y[_rows_here(rows)], dtype=torch.float32, device=device)
               for r, y in y_train.items()}
    y_test = {r: torch.as_tensor(y[_rows_here(rows_te)], dtype=torch.float32, device=device)
              for r, y in y_test.items()}
    layers = list(train_f32)
    alphas = default_alphas()

    y_tr_cat = torch.cat([y_train[r] for r in regions], dim=1)
    col_slices: Dict[str, slice] = {}
    off = 0
    for r in regions:
        col_slices[r] = slice(off, off + y_train[r].shape[1])
        off += y_train[r].shape[1]

    rng = np.random.RandomState(seed)
    split = int(0.8 * n_train)
    perm = rng.permutation(n_train)
    fit_idx, val_idx = perm[:split], perm[split:]

    # ── 1. Layer selection: stacked by width ──
    val_r: Dict[str, np.ndarray] = {}
    widths: Dict[int, list] = {}
    for l in layers:
        widths.setdefault(train_f32[l].shape[1], []).append(l)
    for group in widths.values():
        xs = torch.stack([train_f32[l] for l in group])
        rs = ridge_cv_selection_val_r(xs, y_tr_cat, fit_idx, val_idx, alphas=alphas,
                                      precision=cv_precision, device=device, rows=rows)
        del xs
        for l, row in zip(group, rs.cpu().numpy()):
            val_r[l] = row
    del y_tr_cat

    per_region_selection: Dict[str, list] = {}
    per_region_best: Dict[str, str] = {}
    for r in regions:
        scores = [{"layer": l, "score": float(val_r[l][col_slices[r]].mean())} for l in layers]
        per_region_selection[r] = scores
        per_region_best[r] = max(scores, key=lambda s: s["score"])["layer"]
        if verbose:
            rprint(f"  [{r}] best layer: {per_region_best[r]} "
                   f"(val r={max(s['score'] for s in scores):.4f})", style="highlight")

    # ── 2. Refit once per unique best layer (same rng: bootstrap draws next) ──
    boot_idx = None
    if bootstrap:
        boot_idx = torch.as_tensor(_boot_indices(rng, n_test, n_bootstrap), dtype=torch.long,
                                   device=device)
    jobs = _build_refit_jobs(train_f32, test_f32, y_train, y_test, regions, per_region_best,
                             reconstruct_pca_k, rows, rows_te)
    if _defer:
        return {"jobs": jobs, "selection": per_region_selection, "best": per_region_best,
                "boot_idx": boot_idx, "col_slices": col_slices, "bootstrap": bootstrap}
    refits = []
    for j in jobs:
        y_tr_m, y_te_m = _job_targets(j)
        refits.append(ridge_cv_refit_predict(j["x_tr"], y_tr_m, j["x_te"], y_te_m, alphas=alphas,
                                             precision=cv_precision, device=device,
                                             rows=rows, rows_te=rows_te))
    return _assemble_subject_results(jobs, refits, per_region_selection, bootstrap, boot_idx,
                                     col_slices)


def _build_refit_jobs(train_f32, test_f32, y_train, y_test, regions, per_region_best,
                      reconstruct_pca_k=None, rows=None, rows_te=None):
    """One refit job per unique selected layer (its rows PCA-reconstructed
    with ``reconstruct_pca_k``). Jobs hold REFERENCES to the per-region
    target blocks (concatenated only at refit time), so deferring refits
    across subjects never duplicates the targets; and the row layouts of
    the train and test blocks (None for whole arrays)."""
    by_layer: Dict[str, list] = {}
    for r in regions:
        by_layer.setdefault(per_region_best[r], []).append(r)
    jobs = []
    for layer, members in by_layer.items():
        x_tr, x_te = _reconstructed(train_f32[layer], test_f32[layer], reconstruct_pca_k, rows)
        jobs.append({"layer": layer, "members": members, "x_tr": x_tr, "x_te": x_te,
                     "y_tr_parts": [y_train[r] for r in members],
                     "y_te_parts": [y_test[r] for r in members],
                     "rows": rows, "rows_te": rows_te})
    return jobs


def _job_targets(job):
    """One job's per-region target blocks, concatenated (train, test)."""
    parts_tr, parts_te = job["y_tr_parts"], job["y_te_parts"]
    if len(parts_tr) == 1:
        return parts_tr[0], parts_te[0]
    return torch.cat(parts_tr, dim=1), torch.cat(parts_te, dim=1)


def _assemble_subject_results(jobs, refits, per_region_selection, bootstrap, boot_idx,
                              col_slices) -> Dict[str, List[Dict]]:
    results: Dict[str, List[Dict]] = {}
    for job, (pred, voxel_r, y_te_n) in zip(jobs, refits):
        off = 0
        for r in job["members"]:
            v_r = col_slices[r].stop - col_slices[r].start
            sl = slice(off, off + v_r)
            off += v_r
            point = float(voxel_r[sl].mean())
            ci_low = ci_high = None
            bootstrap_scores_list = None
            if bootstrap:
                scores = _bootstrap_pred_scores(y_te_n[:, sl], pred[:, sl], boot_idx)
                scores = scores.cpu().numpy().astype(np.float64)
                ci_low, ci_high = percentile_ci(scores)
                bootstrap_scores_list = scores.tolist()

            msg = f"    [{r}] Encoding  | {job['layer']} = {point:.4f}"
            if bootstrap:
                msg += f"  [95% CI: {ci_low:.4f}, {ci_high:.4f}]"
            rprint(msg, style="highlight")
            result = {
                "layer": job["layer"], "compare_method": "pearson", "score": point,
                "ci_low": ci_low, "ci_high": ci_high, "analysis": "encoding_score",
                "layer_selection_scores": per_region_selection[r],
            }
            if bootstrap_scores_list is not None:
                result["bootstrap_scores"] = bootstrap_scores_list
            results[r] = [result]
    return results


def compute_encoding_scores_subjects(subject_inputs: Dict, bootstrap: bool = True,
                                     n_bootstrap: int = 1000, seed: int = 42,
                                     verbose: bool = False,
                                     reconstruct_pca_k: int | None = None,
                                     cv_precision: str = "highest", device=None,
                                     mesh=None) -> Dict:
    """Multi-subject encoding eval with CROSS-SUBJECT grouped refits.

    subject_inputs: {subject: (acts_train, acts_test, y_train, y_test)}.
    Selection runs per subject; then every (subject, unique layer) refit's
    full-train eigendecomposition runs in one batched eigh before the
    per-region assembly. Numbers equal per-subject calls'. ``mesh``: the
    row-sharded route of ``compute_encoding_scores_subject``.
    Returns {subject: {region: [result]}}.
    """
    LAST_PHASE_TIMES.clear()
    with span("encoding.selection") as step:
        deferred = {}
        for subj, (a_tr, a_te, y_tr, y_te) in subject_inputs.items():
            rprint(f"\n  -- Subject: {subj} (all regions batched) --", style="info")
            deferred[subj] = compute_encoding_scores_subject(
                a_tr, a_te, y_tr, y_te, bootstrap=bootstrap, n_bootstrap=n_bootstrap, seed=seed,
                verbose=verbose, reconstruct_pca_k=reconstruct_pca_k, cv_precision=cv_precision,
                device=device, mesh=mesh, _defer=True)
    LAST_PHASE_TIMES["selection_s"] = step.seconds

    with span("encoding.refit") as step:
        all_jobs = [j for d in deferred.values() for j in d["jobs"]]
        refits = ridge_cv_refit_predict_grouped(all_jobs, precision=cv_precision, device=device)
        if all_jobs and all_jobs[0]["x_tr"].is_cuda:
            torch.cuda.synchronize(all_jobs[0]["x_tr"].device)  # bill the queued refits here
    LAST_PHASE_TIMES["refit_s"] = step.seconds

    with span("encoding.assemble_bootstrap") as step:
        out = {}
        k = 0
        for subj, d in deferred.items():
            n_jobs = len(d["jobs"])
            out[subj] = _assemble_subject_results(d["jobs"], refits[k:k + n_jobs],
                                                  d["selection"], d["bootstrap"],
                                                  d["boot_idx"], d["col_slices"])
            k += n_jobs
    LAST_PHASE_TIMES["assemble_bootstrap_s"] = step.seconds
    return out
