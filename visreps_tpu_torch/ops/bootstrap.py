"""Grouped Spearman scoring with bootstrap CIs (port of
``visreps_tpu/ops/bootstrap.py:35-51, 185-303, 396-497, 654-655``).

Every (region, subject) pair is scored against the SAME bootstrap index
sets (numpy RandomState(42), bit-identical to the reference's serial
draws). The point score is the average-tie Spearman of the full RDM
triangles; each bootstrap score is the average-tie Spearman of the
sub-RDM triangle of a 90 % stimulus subsample, computed sort-free:

  * every full triangle is sorted ONCE; its tie groups are contiguous
    runs of the sorted order (``stats.tie_groups``);
  * per iteration the selected pairs form a mask; a cumulative sum of
    the mask in sorted order gives, for each tie group, the selected
    count before it and inside it — hence the subset's average rank of
    every element, without sorting the subset;
  * the score is the Pearson correlation of the masked rank vectors.

Model-side ranks are shared by the pairs that selected the same layer;
iterations run in chunks as batched tensor ops.

``bootstrap_rdm_correlation`` scores ONE pair by any method
(``ops/bootstrap.py:607`` of the JAX package):
Spearman by dense ranks (``spearman_fast_scores``, sort-free, the Σd²
form) or average-tie ranks (``spearman_exact_scores``), Kendall by the
block-contraction bootstrap (``ops/kendall.py``), Pearson (and any other
method) by gathering each iteration's sub-triangle (``gathered_scores``).

Under a ``mesh`` whose 'data' axis has several ranks (and no more ranks
than iterations), ``grouped_scoring``, ``single_pair_scoring`` and
``bootstrap_rdm_correlation`` shard the iterations over 'data', as the
JAX package's ``_grouped_scoring_sharded`` and ``_bootstrap_sharded`` do
(``parallel/shard.shard_iterations``): each rank scores its slice of the
index sets against the same RDMs, and every rank returns every score.
"""
from __future__ import annotations

import numpy as np
import torch

from visreps_tpu_torch.device import input_device
from visreps_tpu_torch.ops.kendall import bootstrap_kendall_fast
from visreps_tpu_torch.ops.rdm import compute_rdm, index_sets, selection_masks, triu_indices
from visreps_tpu_torch.ops.stats import kendall_tau_a, pearson_corr, spearman_corr, tie_groups
from visreps_tpu_torch.parallel.mesh import axis_size
from visreps_tpu_torch.parallel.shard import shard_iterations, shards_iterations

_CORR = {"pearson": pearson_corr, "spearman": spearman_corr, "kendall": kendall_tau_a}

# Index sets per Kendall chunk: its (P, chunk) masks and prefix counts
# are ~0.5 GB each in f32 at n = 1000 (the JAX package's chunk).
_KENDALL_CHUNK = 250


def bootstrap_indices(n_test: int, n_bootstrap: int = 1000, subsample_frac: float = 0.9,
                      seed: int | np.random.RandomState = 42) -> np.ndarray:
    """(n_bootstrap, n_sub) without-replacement index sets, drawn with
    ``np.random.RandomState(seed).choice`` per iteration exactly as the
    reference and the JAX package draw them; a RandomState given as
    ``seed`` is drawn from where its stream stands."""
    rng = seed if isinstance(seed, np.random.RandomState) else np.random.RandomState(seed)
    n_sub = int(n_test * subsample_frac)
    return np.stack(
        [rng.choice(n_test, size=n_sub, replace=False) for _ in range(n_bootstrap)]
    ).astype(np.int32)


def percentile_ci(scores: np.ndarray, low: float = 2.5, high: float = 97.5):
    return float(np.percentile(scores, low)), float(np.percentile(scores, high))


def _centered(ranks: torch.Tensor, sel: torch.Tensor | None, m: float):
    """Masked, centred rank vectors and their squared norms."""
    if sel is None:
        d = ranks - ranks.mean(dim=-1, keepdim=True)
    else:
        mu = (sel * ranks).sum(-1, keepdim=True) / m
        d = sel * (ranks - mu)
    return d, (d * d).sum(-1)


def _subset_ranks(sel: torch.Tensor, groups) -> torch.Tensor:
    """(c, M) selection masks → (c, M) average ranks of every element
    within its iteration's selected subset (valid where sel == 1)."""
    order, pos, gs, ge = groups
    ms = sel[:, order]                      # mask in sorted order
    cs = torch.cumsum(ms, dim=1)            # inclusive prefix count
    pre_g = cs[:, gs] - ms[:, gs]           # selected before the group
    k_g = cs[:, ge] - pre_g                 # selected inside the group
    return (pre_g + 0.5 * (k_g + 1.0))[:, pos]


def grouped_core(model_tris: torch.Tensor, neural_tris: torch.Tensor,
                 pair_model: list[int], idx: torch.Tensor, n: int, chunk: int = 128):
    """(L, M) model triangles, (P, M) neural triangles, pair → model row,
    (B, m_sub) index sets over n stimuli → ((P, B) bootstrap scores,
    (P,) point scores), both average-tie Spearman."""
    device = model_tris.device
    P = neural_tris.shape[0]
    B, m_sub = idx.shape
    m = float(m_sub * (m_sub - 1) // 2)
    groups_m = [tie_groups(v) for v in model_tris]
    groups_n = [tie_groups(v) for v in neural_tris]

    def full_ranks(g):
        _, pos, gs, ge = g
        return (0.5 * (gs + ge).to(torch.float32) + 1.0)[pos]

    dm, nm = zip(*(_centered(full_ranks(g), None, 0.0) for g in groups_m))
    points = torch.stack([
        (dm[pm] * db).sum() / torch.sqrt(nm[pm] * nb)
        for pm, (db, nb) in zip(pair_model, (_centered(full_ranks(g), None, 0.0)
                                             for g in groups_n))])
    scores = torch.zeros((P, B), dtype=torch.float32, device=device)
    if B == 0:
        return scores, points
    iu, ju = triu_indices(n, device)
    for start in range(0, B, chunk):
        ix = idx[start:start + chunk]
        sel = selection_masks(ix, n, iu, ju)                            # (c, M)
        model_side = [_centered(_subset_ranks(sel, g), sel, m) for g in groups_m]
        for p, (pm, g) in enumerate(zip(pair_model, groups_n)):
            db, nb = _centered(_subset_ranks(sel, g), sel, m)
            da, na = model_side[pm]
            scores[p, start:start + ix.shape[0]] = (da * db).sum(-1) / torch.sqrt(na * nb)
    return scores, points


def _grouped(model_tris, neural_tris, pair_model, idx, n, chunk, mesh):
    """``grouped_core``, its iterations sharded over ``mesh``'s 'data'
    axis where ``shards_iterations`` says so."""
    if not shards_iterations(mesh, idx.shape[0]):
        return grouped_core(model_tris, neural_tris, pair_model, idx, n, chunk)
    local = -(-idx.shape[0] // axis_size(mesh))
    points = []

    def body(ix):
        scores, p = grouped_core(model_tris, neural_tris, pair_model, ix, n,
                                 max(1, min(chunk, local)))
        points.append(p)
        return scores

    scores = shard_iterations(body, idx, mesh)
    return scores, points[0]


def grouped_scoring(model_rdms: dict, pair_neural_mats: dict, pair_layer: dict,
                    indices: np.ndarray, chunk: int = 128, mesh=None):
    """Whole scoring phase for every pair.

    model_rdms: {layer: (n, n) tensor}; pair_neural_mats: {pair: (n, v)
    responses}; pair_layer: {pair: layer}; indices: (B, m_sub) bootstrap
    index sets (B may be 0). The neural RDMs are built here, on the
    model RDMs' device. Returns ({pair: (B,) float64 bootstrap scores},
    {pair: float point score}). Under a multi-rank ``mesh`` the
    iterations shard over 'data'.
    """
    pair_keys = list(pair_neural_mats)
    layers = sorted({pair_layer[k] for k in pair_keys})
    row = {l: i for i, l in enumerate(layers)}
    device = model_rdms[layers[0]].device
    n = model_rdms[layers[0]].shape[0]
    iu, ju = triu_indices(n, device)
    model_tris = torch.stack([model_rdms[l][iu, ju] for l in layers])
    neural_tris = torch.stack([
        compute_rdm(torch.as_tensor(np.asarray(pair_neural_mats[k], np.float32), device=device))[iu, ju]
        for k in pair_keys])
    scores, points = _grouped(model_tris, neural_tris, [row[pair_layer[k]] for k in pair_keys],
                              index_sets(indices, device), n, chunk, mesh)
    scores = scores.cpu().numpy().astype(np.float64)
    points = points.cpu().numpy().astype(np.float64)
    return ({k: scores[i] for i, k in enumerate(pair_keys)},
            {k: float(points[i]) for i, k in enumerate(pair_keys)})


def single_pair_scoring(model_acts, neural_acts, indices: np.ndarray, chunk: int = 128,
                        device=None, mesh=None):
    """Scoring of ONE (model, neural) pair from its activation matrices:
    the two RDMs (the kernel on the card), then ``grouped_core`` with
    one layer and one pair. ``model_acts`` (n, d) and ``neural_acts``
    (n, v) are tensors or arrays; they are scored on ``device`` (default:
    ``model_acts``' device; an array needs ``device``). Returns ((B,)
    float64 average-tie Spearman bootstrap scores, float average-tie
    Spearman point score). Under a multi-rank ``mesh`` the iterations
    shard over 'data'."""
    device = input_device(model_acts, device)
    model = torch.as_tensor(model_acts).to(device)
    neural = torch.as_tensor(neural_acts).to(device, torch.float32)
    n = model.shape[0]
    iu, ju = triu_indices(n, model.device)
    model_tris = compute_rdm(model.reshape(n, -1))[iu, ju][None]
    neural_tris = compute_rdm(neural.reshape(n, -1))[iu, ju][None]
    scores, points = _grouped(model_tris, neural_tris, [0], index_sets(indices, device), n,
                              chunk, mesh)
    return scores[0].cpu().numpy().astype(np.float64), float(points[0])


def spearman_fast_scores(rdm_a: torch.Tensor, rdm_b: torch.Tensor, idx: torch.Tensor,
                         chunk: int = 250) -> torch.Tensor:
    """(B,) f32 dense-rank Spearman of each index set's sub-RDM triangles,
    sort-free (``_spearman_fast_body`` of the JAX package): the full
    triangles are argsorted once; an element's rank in an iteration's
    subset is the selected count at or before its sorted position (a
    cumulative sum of the mask in sorted order), so ranks are a
    permutation and rho = 1 − 6·Σd² / (m(m² − 1)). Equal to scipy where
    the selected values are distinct. Ranks and Σd² are int64 (exact)."""
    n = rdm_a.shape[0]
    m_sub = idx.shape[1]
    iu, ju = triu_indices(n, rdm_a.device)
    order_a = torch.argsort(rdm_a[iu, ju], stable=True)
    order_b = torch.argsort(rdm_b[iu, ju], stable=True)
    pos_a, pos_b = torch.argsort(order_a), torch.argsort(order_b)
    m = float(m_sub * (m_sub - 1) // 2)
    out = []
    for start in range(0, idx.shape[0], max(1, chunk)):
        sel = selection_masks(idx[start:start + chunk], n, iu, ju, torch.int64)
        ra = torch.cumsum(sel[:, order_a], dim=1)[:, pos_a]
        rb = torch.cumsum(sel[:, order_b], dim=1)[:, pos_b]
        d2 = (sel * (ra - rb) ** 2).sum(1).to(torch.float64)
        out.append((1.0 - 6.0 * d2 / (m * (m * m - 1.0))).to(torch.float32))
    return torch.cat(out) if out else torch.zeros(0, device=rdm_a.device)


def spearman_exact_scores(rdm_a: torch.Tensor, rdm_b: torch.Tensor, idx: torch.Tensor,
                          chunk: int = 128) -> torch.Tensor:
    """(B,) f32 average-tie Spearman of each index set's sub-RDM
    triangles (``_spearman_exact_body``): ``grouped_core`` with one
    layer and one pair."""
    n = rdm_a.shape[0]
    iu, ju = triu_indices(n, rdm_a.device)
    scores, _ = grouped_core(rdm_a[iu, ju][None], rdm_b[iu, ju][None], [0], idx, n, chunk)
    return scores[0]


def gathered_scores(rdm_a: torch.Tensor, rdm_b: torch.Tensor, idx: torch.Tensor,
                    method: str, chunk: int = 250) -> torch.Tensor:
    """(B,) f32 ``method`` correlation of each index set's sub-RDM
    triangles, gathered straight from the full matrices (``_scores_body``:
    entry (ix[i], ix[j]) for i < j; the RDMs are symmetric)."""
    fn = _CORR[method]
    iu, ju = triu_indices(idx.shape[1], rdm_a.device)
    out = []
    for start in range(0, idx.shape[0], max(1, chunk)):
        ix = idx[start:start + chunk]
        ia, ja = ix[:, iu], ix[:, ju]
        out.append(fn(rdm_a[ia, ja], rdm_b[ia, ja]))
    return torch.cat(out) if out else torch.zeros(0, device=rdm_a.device)


def bootstrap_rdm_correlation(rdm_model, rdm_neural, n_bootstrap: int = 1000,
                              subsample_frac: float = 0.9, seed: int = 42,
                              method: str = "spearman", chunk: int = 250,
                              indices: np.ndarray | None = None,
                              exact_ties: bool = False, device=None, mesh=None) -> np.ndarray:
    """(B,) float64 bootstrap distribution of one (model, neural) RDM
    pair's correlation, over ``indices`` (default: ``bootstrap_indices``
    of ``n_bootstrap``, ``subsample_frac`` and ``seed``), on ``device``
    (default: the model RDM's; an array needs ``device``).

    Spearman takes the dense-rank body (equal to scipy where the sampled
    values are distinct), or with ``exact_ties`` the average-tie one;
    Kendall the block-contraction body in chunks of at most 250; Pearson
    the gathered sub-triangles. Under a multi-rank ``mesh`` the
    iterations shard over 'data', each rank's chunk at most its slice."""
    device = input_device(rdm_model, device)
    rdm_model = torch.as_tensor(rdm_model).to(device, torch.float32)
    rdm_neural = torch.as_tensor(rdm_neural).to(device, torch.float32)
    if indices is None:
        indices = bootstrap_indices(rdm_model.shape[0], n_bootstrap, subsample_frac, seed)
    idx = index_sets(indices, device)
    method = method.lower()
    sharded = shards_iterations(mesh, idx.shape[0])
    if sharded:
        chunk = max(1, min(chunk, -(-idx.shape[0] // axis_size(mesh))))

    def body(ix):
        if method == "spearman":
            return (spearman_exact_scores(rdm_model, rdm_neural, ix) if exact_ties
                    else spearman_fast_scores(rdm_model, rdm_neural, ix, chunk))
        if method == "kendall":
            return bootstrap_kendall_fast(rdm_model, rdm_neural, ix, min(chunk, _KENDALL_CHUNK))
        return gathered_scores(rdm_model, rdm_neural, ix, method, chunk)

    scores = shard_iterations(body, idx, mesh) if sharded else body(idx)
    return scores.cpu().numpy().astype(np.float64)


def bootstrap_rdm_correlation_grouped(model_rdms: dict, pair_neural: dict, pair_layer: dict,
                                      indices: np.ndarray, chunk: int = 128,
                                      device=None) -> dict:
    """Every pair's average-tie Spearman bootstrap against the same index
    sets: model_rdms {layer: (n, n)}, pair_neural {pair: (n, n)},
    pair_layer {pair: layer}. Returns {pair: (B,) float64}; on ``device``
    (default: the first model RDM's; arrays need ``device``)."""
    pair_keys = list(pair_neural)
    layers = sorted({pair_layer[k] for k in pair_keys})
    row = {l: i for i, l in enumerate(layers)}
    first = model_rdms[layers[0]]
    device = input_device(first, device)
    n = first.shape[0]
    iu, ju = triu_indices(n, device)

    def tri(x):
        return torch.as_tensor(x).to(device, torch.float32)[iu, ju]

    scores, _ = grouped_core(torch.stack([tri(model_rdms[l]) for l in layers]),
                             torch.stack([tri(pair_neural[k]) for k in pair_keys]),
                             [row[pair_layer[k]] for k in pair_keys],
                             index_sets(indices, device), n, chunk)
    scores = scores.cpu().numpy().astype(np.float64)
    return {k: scores[i] for i, k in enumerate(pair_keys)}
