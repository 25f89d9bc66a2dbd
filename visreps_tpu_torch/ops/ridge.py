"""Multi-alpha ridge regression with per-target CV (port of
``visreps_tpu/ops/ridge.py``, the himalaya ``RidgeCV`` replacement).

Same protocol and the same two solver routes as the JAX package:

  * per-fold eigh (``_ridge_cv_impl``): each fold's train Gram is the
    full Gram minus the fold's own product, diagonalised once, and the 20
    alphas are diagonal reweightings of that one factorisation;
  * Woodbury (``_wood_cv_scores``): one eigh of the full Gram, each fold
    a rank-n_val downdate solved through the (n_val, n_val) system
    ``s = I − K``, whose inverse is applied as a product. Taken when every
    fold's train block has full column rank (``_woodbury_ok``).

Per-voxel alpha by mean CV R² over contiguous KFold folds, no intercept.

Precision: the Grams, eigendecompositions, ``K``, the small inverse, the
refit weights and the predictions are float32 at every setting, whatever
the caller's TF32 switch (the public functions hold it off while they
run). ``precision="high"`` (or ``"default"``) lets only the sweep's
v-wide products (``r1``, ``inv(s)·r1`` and ``K·z``) use TF32 tensor cores
on a CUDA device; ``"highest"`` keeps them f32. CPU products are f32
either way.

Eigenvector signs and bases of degenerate eigenspaces differ between
LAPACK, cuSOLVER and XLA; the ridge solution ``V diag(·) Vᵀ`` does not.

Row blocks (the encoding eval under a mesh, the JAX package's
``P("data", None)`` inputs): with ``rows`` (``parallel.shard.RowBlocks``)
each rank passes its block of the rows. Every reduction over rows sums
per-block partials over the 'data' ranks: column means, then Bessel stds
from the squared deviations; Grams and cross-products; Pearson's sums.
Each CV fold's rows are gathered whole and the fold is scored on one rank
(fold f on data rank f mod K), which broadcasts its (A, v) R²; each Gram's
eigh runs on one rank and is broadcast; test predictions are made from the
local rows and gathered in row order. Every rank so ends with the same
bits. ``rows=None`` is the single-process route.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from visreps_tpu_torch.device import input_device

_PRECISIONS = ("default", "high", "highest")


@dataclass
class RidgeCVResult:
    weights: torch.Tensor      # (d, v) — fit_intercept=False
    best_alphas: torch.Tensor  # (v,)
    cv_scores: torch.Tensor    # (n_alphas, v) mean R² across folds

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        with _tf32(False):
            return x.to(torch.float32) @ self.weights


def default_alphas(n: int = 20) -> np.ndarray:
    """logspace(−10, 10, 20) — reference: encoding_score.py:108."""
    return np.logspace(-10, 10, n)


def _kfold_bounds(n: int, n_folds: int) -> list[tuple[int, int]]:
    """Contiguous KFold boundaries (first n % k folds one larger)."""
    sizes = [n // n_folds + (1 if i < n % n_folds else 0) for i in range(n_folds)]
    bounds, start = [], 0
    for s in sizes:
        bounds.append((start, start + s))
        start += s
    return bounds


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@contextmanager
def _tf32(enabled: bool):
    """CUDA matmuls inside the block on TF32 tensor cores or in full f32;
    restores the caller's setting on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _check_precision(precision: str) -> None:
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, got {precision!r}")


def _gram(x: torch.Tensor) -> torch.Tensor:
    """Xᵀ X of (…, n, d) rows: every Gram of the ridge is made here."""
    return x.mT @ x


def _rsum(t: torch.Tensor, rows) -> torch.Tensor:
    """A per-block partial summed over the row blocks (itself in one process)."""
    return t if rows is None else rows.sum(t)


def _gram_eigh(g: torch.Tensor, rows=None):
    """eigh of the symmetrised Gram (or batch of Grams, as ``jnp.linalg.eigh``
    symmetrises its input), eigenvalues clamped at 0 (f32 roundoff). Under
    row blocks Gram i is diagonalised on data rank i mod K and broadcast,
    so every rank holds the same eigenvectors."""
    if rows is None:
        lam, v = torch.linalg.eigh(0.5 * (g + g.mT))
        return lam.clamp_min(0.0), v
    batch = g.reshape(-1, *g.shape[-2:])
    lam, vec = g.new_empty(batch.shape[:-1]), torch.empty_like(batch)
    mine = list(range(rows.me, batch.shape[0], rows.size))
    if mine:
        lam[mine], vec[mine] = _gram_eigh(batch[mine])
    for i in range(batch.shape[0]):
        rows.share(lam[i], i % rows.size)
        rows.share(vec[i], i % rows.size)
    return lam.reshape(g.shape[:-1]), vec.reshape(g.shape)


def _weights(v_eig, lam, c, best_alpha):
    """Per-voxel-alpha ridge weights from the Gram's eigendecomposition."""
    b = v_eig.T @ c
    return v_eig @ (b / (lam[:, None] + best_alpha[None, :]))


def _r2_per_target(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    y_mean = y_true.mean(dim=0, keepdim=True)
    sse = ((y_true - y_pred) ** 2).sum(dim=0)
    ss = ((y_true - y_mean) ** 2).sum(dim=0)
    ss = torch.where(ss == 0, 1.0, ss)
    return 1.0 - sse / ss


def correlation_score(y_true: torch.Tensor, y_pred: torch.Tensor, rows=None) -> torch.Tensor:
    """Per-column (voxel) Pearson r — himalaya.scoring.correlation_score;
    0 where either column is constant. Under row blocks from the
    all-reduced column sums."""
    if rows is None:
        yt = y_true - y_true.mean(dim=0, keepdim=True)
        yp = y_pred - y_pred.mean(dim=0, keepdim=True)
        denom = torch.sqrt((yt * yt).sum(dim=0) * (yp * yp).sum(dim=0))
        return torch.where(denom > 0, (yt * yp).sum(dim=0) / denom, 0.0)
    means = rows.sum(torch.stack([y_true.sum(dim=0), y_pred.sum(dim=0)])) / rows.n
    yt, yp = y_true - means[0], y_pred - means[1]
    s = rows.sum(torch.stack([(yt * yt).sum(dim=0), (yp * yp).sum(dim=0), (yt * yp).sum(dim=0)]))
    denom = torch.sqrt(s[0] * s[1])
    return torch.where(denom > 0, s[2] / denom, 0.0)


class _Folds:
    """The contiguous KFold folds of a ridge's rows, the targets' fold rows
    cut once for every design scored against them. Under row blocks each
    fold's rows are gathered whole and the fold is scored on data rank
    f mod K, which broadcasts its (A, v) R²; every rank adds the folds in
    fold order, as one process does."""

    def __init__(self, y: torch.Tensor, n_folds: int, rows=None):
        self.rows, self.n_folds, self.v = rows, n_folds, y.shape[1]
        self.bounds = _kfold_bounds(y.shape[0] if rows is None else rows.n, n_folds)
        self.y = self._cut(y)

    def _cut(self, t: torch.Tensor) -> list:
        """Each fold's rows of ``t``, None for a fold another rank scores."""
        if self.rows is None:
            return [t[start:stop] for start, stop in self.bounds]
        parts = []
        for f, (start, stop) in enumerate(self.bounds):
            part = self.rows.gather(t, torch.arange(start, stop))
            parts.append(part if f % self.rows.size == self.rows.me else None)
        return parts

    def mean(self, x: torch.Tensor, score, n_alphas: int) -> torch.Tensor:
        """(A, v) mean over the folds of ``score(x_val, y_val)``."""
        scores = [None if xv is None else score(xv, yv) for xv, yv in zip(self._cut(x), self.y)]
        total = torch.zeros((n_alphas, self.v), dtype=torch.float32, device=x.device)
        for f, s in enumerate(scores):
            if self.rows is not None:
                s = self.rows.share(torch.empty_like(total) if s is None else s,
                                    f % self.rows.size)
            total += s
        return total / self.n_folds


def _eigh_cv_scores(x, folds, g, c, alphas):
    """(A, v) mean CV R² of the per-fold-eigh route: each fold's train
    Gram is the full Gram ``g`` minus the fold's own product."""
    def score(xv, yv):
        lam, v = _gram_eigh(g - _gram(xv))
        b = v.T @ (c - xv.T @ yv)
        p = xv @ v
        return torch.stack([_r2_per_target(yv, p @ (b / (lam[:, None] + alphas[i])))
                            for i in range(alphas.shape[0])])

    return folds.mean(x, score, alphas.shape[0])


def _ridge_cv_impl(x, y, alphas, n_folds, rows=None):
    """Per-fold-eigh RidgeCV → (weights, best alphas, (A, v) CV R²)."""
    g = _rsum(_gram(x), rows)
    c = _rsum(x.T @ y, rows)
    cv_scores = _eigh_cv_scores(x, _Folds(y, n_folds, rows), g, c, alphas)
    best_alpha = alphas[cv_scores.argmax(dim=0)]
    lam, v = _gram_eigh(g, rows)
    return _weights(v, lam, c, best_alpha), best_alpha, cv_scores


def _wood_cv_scores(x, folds, lam, v_eig, c, alphas, precision):
    """(A, v) mean CV R² via Woodbury downdates of the FULL Gram's eigh:

        (G_f + aI)^{-1} = V (D_a − U Uᵀ)^{-1} Vᵀ,   U = Vᵀ X_valᵀ,

    through the (n_val, n_val) system s = I − K, K = Ũᵀ Ũ, Ũ = D_a^{-1/2} U.
    Well-conditioned when every fold's train block has full column rank
    (the caller's gate): λ_min(s) = O(n / λ_max) > 0 even at alpha → 0.
    """
    b_full = v_eig.T @ c                                   # (d, v), once
    dinv = 1.0 / (lam[None, :] + alphas[:, None])          # (A, d)

    def score(xv, yv):
        eye = torch.eye(xv.shape[0], dtype=torch.float32, device=xv.device)
        u = v_eig.T @ xv.T                                 # (d, nv)
        ct = b_full - u @ yv                               # Vᵀ c_f, (d, v)
        ut = u[None] * torch.sqrt(dinv)[:, :, None]        # (A, d, nv)
        k = ut.mT @ ut                                     # (A, nv, nv), f32 at every precision
        del ut
        # All alphas' small systems in one call: on an H100 20 inverses of
        # (1440, 1440) took 54.7 ms batched against 79.8 ms one by one
        # (chip_smoke.py, encoding_linalg). inv_ex does not synchronise the host.
        s_inv = torch.linalg.inv_ex(eye - k).inverse
        r2 = []
        for i in range(alphas.shape[0]):
            with _tf32(precision != "highest"):
                r1 = u.T @ (ct * dinv[i][:, None])         # (nv, v)
                pred = r1 + k[i] @ (s_inv[i] @ r1)
            r2.append(_r2_per_target(yv, pred))
        return torch.stack(r2)

    return folds.mean(x, score, alphas.shape[0])


def _ridge_cv_wood_impl(x, y, alphas, n_folds, precision="highest", rows=None):
    g = _rsum(_gram(x), rows)
    c = _rsum(x.T @ y, rows)
    lam, v_eig = _gram_eigh(g, rows)
    del g
    cv_scores = _wood_cv_scores(x, _Folds(y, n_folds, rows), lam, v_eig, c, alphas, precision)
    best_alpha = alphas[cv_scores.argmax(dim=0)]
    return _weights(v_eig, lam, c, best_alpha), best_alpha, cv_scores


def _woodbury_ok(n: int, d: int, n_folds: int) -> bool:
    """Every fold's train block must have full column rank (with slack)
    for the Woodbury small system to stay well-conditioned."""
    max_fold = n // n_folds + (1 if n % n_folds else 0)
    return (n - max_fold) >= d


def _use_wood(solver: str, n: int, d: int, n_folds: int) -> bool:
    return solver == "woodbury" or (solver == "auto" and _woodbury_ok(n, d, n_folds))


def ridge_cv(x, y, alphas=None, n_folds: int = 5, solver: str = "auto",
             device=None) -> RidgeCVResult:
    """Fit ridge with per-target alpha chosen by n-fold CV (no intercept).

    Callers pass z-normalised x and y. solver: "auto" takes the Woodbury
    route when n − max_fold ≥ d, else per-fold eigh; "eigh"/"woodbury"
    force one.
    """
    device = input_device(x, device)
    if alphas is None:
        alphas = default_alphas()
    x, y, a = _f32(x, device), _f32(y, device), _f32(alphas, device)
    with _tf32(False):
        if _use_wood(solver, x.shape[0], x.shape[1], n_folds):
            w, best_alpha, cv_scores = _ridge_cv_wood_impl(x, y, a, n_folds)
        else:
            w, best_alpha, cv_scores = _ridge_cv_impl(x, y, a, n_folds)
    return RidgeCVResult(weights=w, best_alphas=best_alpha, cv_scores=cv_scores)


def ridge_cv_val_scores_batched(xs_fit, y_fit, xs_val, y_val, alphas=None, n_folds: int = 5,
                                solver: str = "auto", precision: str = "highest",
                                device=None) -> torch.Tensor:
    """(L, n, d) layers, shared (n, v) targets → (L, v) validation Pearson r:
    one batched eigh of the L layer Grams, then per layer the CV sweep,
    per-voxel alpha, fit and validation prediction."""
    device = input_device(xs_fit, device)
    _check_precision(precision)
    if alphas is None:
        alphas = default_alphas()
    xs_fit, y_fit = _f32(xs_fit, device), _f32(y_fit, device)
    xs_val, y_val = _f32(xs_val, device), _f32(y_val, device)
    a = _f32(alphas, device)
    with _tf32(False):
        if _use_wood(solver, xs_fit.shape[1], xs_fit.shape[2], n_folds):
            lams, v_eigs = _gram_eigh(_gram(xs_fit))
            folds = _Folds(y_fit, n_folds)
            rows = [correlation_score(y_val, _cv_and_predict(
                xs_fit[l], y_fit, folds, xs_val[l], lams[l], v_eigs[l], a, precision, True))
                for l in range(xs_fit.shape[0])]
        else:
            rows = [correlation_score(
                y_val, xs_val[l] @ _ridge_cv_impl(xs_fit[l], y_fit, a, n_folds)[0])
                for l in range(xs_fit.shape[0])]
        return torch.stack(rows)


def _col_stats(x, rows=None):
    """Column mean and Bessel std over the rows (axis −2). Under row
    blocks: the mean from all-reduced sums, then the std from all-reduced
    squared deviations from it."""
    if rows is None:
        return x.mean(dim=-2, keepdim=True), x.std(dim=-2, correction=1, keepdim=True)
    m = rows.sum(x.sum(dim=-2, keepdim=True)) / rows.n
    ss = rows.sum(((x - m) ** 2).sum(dim=-2, keepdim=True))
    return m, torch.sqrt(ss / (rows.n - 1))


def _znorm_cols(x, rows=None):
    """Column z-norm with Bessel std + 1e-8 (``ops/znorm`` semantics),
    returning (normed, mean, std)."""
    m, s = _col_stats(x, rows)
    s = s + 1e-8
    return (x - m) / s, m, s


def _cv_and_predict(x_fit, y_fit, folds, x_val, lam, v_eig, alphas, precision, use_wood,
                    rows=None):
    """Per-layer CV alpha choice + full-fit weights + validation predictions."""
    c = _rsum(x_fit.T @ y_fit, rows)
    if use_wood:
        cv = _wood_cv_scores(x_fit, folds, lam, v_eig, c, alphas, precision)
    else:
        cv = _eigh_cv_scores(x_fit, folds, _rsum(_gram(x_fit), rows), c, alphas)
    return x_val @ _weights(v_eig, lam, c, alphas[cv.argmax(dim=0)])


def _selection_val_r_impl(xs, y, fit_idx, val_idx, alphas, n_folds, precision, use_wood,
                          rows=None):
    """Raw stacked layers → (L, v) validation Pearson r: the fit/val
    gather, fit-statistic z-norms, one batched eigh of the L fit Grams,
    then per layer the CV sweep, per-voxel alpha, fit and val prediction.
    Under row blocks ``xs`` and ``y`` are this rank's rows, and each rank
    takes the fit and val rows it holds."""
    if rows is None:
        fit_rows = val_rows = None
    else:
        fit_idx, fit_rows = rows.take(fit_idx)
        val_idx, val_rows = rows.take(val_idx)
        fit_idx, val_idx = fit_idx.to(xs.device), val_idx.to(xs.device)
    xs_fit = xs[:, fit_idx]
    xs_val = xs[:, val_idx]
    y_fit, ym, ysd = _znorm_cols(y[fit_idx], fit_rows)
    y_val = (y[val_idx] - ym) / ysd

    xm, xsd = _col_stats(xs_fit, fit_rows)
    xsd = xsd + 1e-8
    xs_fit.sub_(xm).div_(xsd)  # the gathers are fresh copies: normalise in place
    xs_val.sub_(xm).div_(xsd)
    del xm, xsd

    lams, v_eigs = _gram_eigh(_rsum(_gram(xs_fit), fit_rows), fit_rows)
    folds = _Folds(y_fit, n_folds, fit_rows)
    return torch.stack([
        correlation_score(y_val, _cv_and_predict(xs_fit[l], y_fit, folds, xs_val[l], lams[l],
                                                 v_eigs[l], alphas, precision, use_wood,
                                                 fit_rows), val_rows)
        for l in range(xs.shape[0])])


def ridge_cv_selection_val_r(xs, y, fit_idx, val_idx, alphas=None, n_folds: int = 5,
                             solver: str = "auto", precision: str = "highest",
                             device=None, rows=None) -> torch.Tensor:
    """(L, n, d) RAW layers + (n, v) RAW targets + fit/val split
    → (L, v) per-voxel validation Pearson r (the encoding selection
    criterion, reference: encoding_score.py:129-162). With ``rows``
    (``parallel.shard.RowBlocks``) ``xs`` and ``y`` are this rank's row
    block and the split indexes the global rows."""
    device = input_device(xs, device)
    _check_precision(precision)
    if alphas is None:
        alphas = default_alphas()
    use_wood = _use_wood(solver, len(fit_idx), xs.shape[2], n_folds)
    if rows is None:
        fit_idx = torch.as_tensor(np.asarray(fit_idx), dtype=torch.long, device=device)
        val_idx = torch.as_tensor(np.asarray(val_idx), dtype=torch.long, device=device)
    xs = _f32(xs, device)
    with _tf32(False):
        return _selection_val_r_impl(xs, _f32(y, device), fit_idx, val_idx,
                                     _f32(alphas, device), n_folds, precision, use_wood, rows)


def _test_rows(x_te, w, y_te, rows_te):
    """(pred, voxel r, y_te_normed) of the test rows, predicted from this
    rank's rows and, under row blocks, gathered whole on every rank (the
    bootstrap reads all of them)."""
    pred = x_te @ w
    if rows_te is not None:
        pred, y_te = rows_te.cat(pred), rows_te.cat(y_te)
    return pred, correlation_score(y_te, pred), y_te


def _refit_predict_impl(x_tr, x_te, y_tr, y_te, alphas, n_folds, precision, use_wood,
                        rows=None, rows_te=None):
    """Full-train z-norm + RidgeCV + test prediction.

    Returns (pred, voxel_r, y_te_normed) — pred and y_te_normed feed the
    bootstrap over cached predictions."""
    x_tr, xm, xsd = _znorm_cols(x_tr, rows)
    x_te = (x_te - xm) / xsd
    y_tr, ym, ysd = _znorm_cols(y_tr, rows)
    y_te = (y_te - ym) / ysd
    if use_wood:
        w = _ridge_cv_wood_impl(x_tr, y_tr, alphas, n_folds, precision, rows)[0]
    else:
        w = _ridge_cv_impl(x_tr, y_tr, alphas, n_folds, rows)[0]
    return _test_rows(x_te, w, y_te, rows_te)


def _n_rows(x, rows) -> int:
    return x.shape[0] if rows is None else rows.n


def ridge_cv_refit_predict(x_tr, y_tr, x_te, y_te, alphas=None, n_folds: int = 5,
                           solver: str = "auto", precision: str = "highest", device=None,
                           rows=None, rows_te=None):
    """Refit on the full train split, predict test. Returns
    (pred, voxel_r, y_te_normed) as tensors on ``device``. With ``rows`` /
    ``rows_te`` the train / test arrays are this rank's row blocks, and
    every rank returns the whole test predictions."""
    device = input_device(x_tr, device)
    _check_precision(precision)
    if alphas is None:
        alphas = default_alphas()
    with _tf32(False):
        return _refit_predict_impl(
            _f32(x_tr, device), _f32(x_te, device), _f32(y_tr, device), _f32(y_te, device),
            _f32(alphas, device), n_folds, precision,
            _use_wood(solver, _n_rows(x_tr, rows), x_tr.shape[1], n_folds), rows, rows_te)


def _znormed_gram(x, rows=None):
    xn = _znorm_cols(x, rows)[0]
    return _rsum(_gram(xn), rows)


def _refit_from_eigh_impl(x_tr, x_te, y_tr, y_te, lam, v_eig, alphas, n_folds, precision,
                          rows=None, rows_te=None):
    """Refit given a precomputed eigh of the z-normed train Gram."""
    x_tr, xm, xsd = _znorm_cols(x_tr, rows)
    x_te = (x_te - xm) / xsd
    y_tr, ym, ysd = _znorm_cols(y_tr, rows)
    y_te = (y_te - ym) / ysd
    c = _rsum(x_tr.T @ y_tr, rows)
    cv = _wood_cv_scores(x_tr, _Folds(y_tr, n_folds, rows), lam, v_eig, c, alphas, precision)
    return _test_rows(x_te, _weights(v_eig, lam, c, alphas[cv.argmax(dim=0)]), y_te, rows_te)


def ridge_cv_refit_predict_grouped(jobs, alphas=None, n_folds: int = 5, solver: str = "auto",
                                   precision: str = "highest", device=None):
    """Refit MANY jobs ({"x_tr", "x_te"} and {"y_tr", "y_te"} or the
    per-region "y_tr_parts"/"y_te_parts"), the Woodbury jobs' full-train
    eigendecompositions in one batched eigh (all share d). Jobs that fail
    the fold-rank gate take the per-fold-eigh path one by one. A job's
    "rows" / "rows_te" (``parallel.shard.RowBlocks``, absent or None for
    whole arrays) say that its train / test arrays are this rank's row
    blocks. Returns a list of (pred, voxel_r, y_te_normed) in job order.
    """
    if not jobs:
        return []
    device = input_device(jobs[0]["x_tr"], device)
    _check_precision(precision)
    if alphas is None:
        alphas = default_alphas()
    a = _f32(alphas, device)

    def targets(j):
        if "y_tr" in j:
            return _f32(j["y_tr"], device), _f32(j["y_te"], device)
        from visreps_tpu_torch.analysis.encoding import _job_targets

        y_tr, y_te = _job_targets(j)
        return _f32(y_tr, device), _f32(y_te, device)

    wood_idx = [i for i, j in enumerate(jobs)
                if solver != "eigh" and (solver == "woodbury" or _woodbury_ok(
                    _n_rows(j["x_tr"], j.get("rows")), j["x_tr"].shape[1], n_folds))]
    # every job of a mesh has the same 'data' group; it splits the eighs
    mesh_rows = next((j["rows"] for j in jobs if j.get("rows") is not None), None)
    results: dict = {}
    with _tf32(False):
        if wood_idx:
            lams, v_eigs = _gram_eigh(torch.stack([
                _znormed_gram(_f32(jobs[i]["x_tr"], device), jobs[i].get("rows"))
                for i in wood_idx]), mesh_rows)
            for k, i in enumerate(wood_idx):
                j = jobs[i]
                results[i] = _refit_from_eigh_impl(
                    _f32(j["x_tr"], device), _f32(j["x_te"], device), *targets(j),
                    lams[k], v_eigs[k], a, n_folds, precision, j.get("rows"), j.get("rows_te"))
        for i, j in enumerate(jobs):
            if i not in results:
                results[i] = _refit_predict_impl(
                    _f32(j["x_tr"], device), _f32(j["x_te"], device), *targets(j),
                    a, n_folds, precision, False, j.get("rows"), j.get("rows_te"))
    return [results[i] for i in range(len(jobs))]
