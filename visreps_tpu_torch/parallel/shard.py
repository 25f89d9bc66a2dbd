"""Stimulus-axis and iteration-axis sharding (port of
``visreps_tpu/parallel/shard.py`` and the mesh routes of
``visreps_tpu/ops/bootstrap.py``).

``rdm_sharded`` is the JAX package's row-block ring: each rank of the
'data' axis holds one (n/ndev, d) block of the normalised rows; at every
step it multiplies its block by the visiting one (a ``torch.mm`` tile in
f32 with TF32 off, the JAX package's ``Precision.HIGHEST`` product) and
passes the visiting block on around the ring with
``dist.batch_isend_irecv``. Input memory per rank is its block plus one
block in flight. The row stripes are then all-gathered, so every rank
holds the whole (n, n) RDM, as the JAX global array reads whole. The
ring launches no kernel: its tile is the plain product that the JAX
package computes outside Pallas (``jax.lax.dot``); the RDM kernel keeps
serving ``compute_rdm``.

``extract_sharded_batch`` and ``shard_iterations`` split a batch's rows
or a bootstrap's iterations over 'data', pad them to equal pieces, run
each rank's piece and all-gather the results in global order with the
padding removed. Every collective runs on the mesh's 'data' group (one
ring per 'model' index).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from visreps_tpu_torch.device import resolve_device
from visreps_tpu_torch.ops.stats import rankdata_dense
from visreps_tpu_torch.parallel.mesh import axis_size, rank_device


def _normalize_rows(x: torch.Tensor, correction: float) -> torch.Tensor:
    """Centre and scale rows so the Gram product is the correlation: the
    1/(std·√d) factor folded into each row (the reference's eps in
    std_i·std_j + eps is dropped, as in the JAX package)."""
    x = x - x.mean(dim=1, keepdim=True)
    std = torch.sqrt((x * x).mean(dim=1) + correction)
    std = torch.where(std < correction * 10, torch.ones_like(std), std)
    return x / (std[:, None] * x.shape[1] ** 0.5)


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (same shape on each) concatenated along ``dim``
    in rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def rdm_sharded(x, mesh: DeviceMesh, correlation: str = "pearson",
                correction: float = 1e-12) -> torch.Tensor:
    """(n, d) → (n, n) float32 RDM, rows sharded over the mesh's 'data'
    axis. Semantics of ``ops.rdm.compute_rdm`` (clamp to [−1, 1], zero
    diagonal, 1 − r); Spearman dense-ranks each row first. Rows are
    padded with zeros to a multiple of the axis size and the pad sliced
    off. ``x`` (an array or a tensor, the same on every rank) is read
    only in this rank's row block, which alone moves to the rank's
    device; every rank returns the whole RDM there."""
    if correlation.lower() not in {"pearson", "spearman"}:
        raise ValueError("correlation must be 'Pearson' or 'Spearman'")
    device = resolve_device(rank_device(mesh))  # TF32 off on CUDA
    n, d = x.shape
    ndev, me = axis_size(mesh), mesh.get_local_rank("data")
    group = mesh.get_group("data")
    blk = -(-n // ndev)
    lo, hi = min(me * blk, n), min((me + 1) * blk, n)
    x_blk = torch.zeros((blk, d), dtype=torch.float32, device=device)
    if hi > lo:
        rows = torch.as_tensor(np.asarray(x[lo:hi]) if not torch.is_tensor(x) else x[lo:hi])
        rows = rows.to(device, torch.float32)
        if correlation.lower() == "spearman":
            rows = rankdata_dense(rows, dim=1)
        x_blk[:hi - lo] = rows
    x_blk = _normalize_rows(x_blk, correction)

    nxt = dist.get_global_rank(group, (me + 1) % ndev)
    prv = dist.get_global_rank(group, (me - 1) % ndev)
    stripe = torch.empty((blk, ndev * blk), dtype=torch.float32, device=device)
    cur = x_blk
    for shift in range(ndev):
        src = (me - shift) % ndev  # owner of the visiting block
        stripe[:, src * blk:(src + 1) * blk] = torch.mm(x_blk, cur.T)
        if shift < ndev - 1:
            incoming = torch.empty_like(cur)
            reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, cur, nxt, group=group),
                                           dist.P2POp(dist.irecv, incoming, prv, group=group)])
            for req in reqs:
                req.wait()
            cur = incoming
    corr = stripe.clamp_(-1.0, 1.0)
    diag = torch.arange(blk, device=device)
    corr[diag, me * blk + diag] = 1.0
    rdm = all_gather_cat(1.0 - corr, group)
    return rdm[:n, :n]


def padded_piece(n: int, ndev: int, me: int) -> tuple[int, slice]:
    """(rows per rank after padding n to a multiple of ndev, this rank's
    slice of the padded axis)."""
    per = -(-n // ndev)
    return per, slice(me * per, (me + 1) * per)


def _pad_rows(x, n_pad: int):
    """``x`` with its last row repeated up to ``n_pad`` rows."""
    n = x.shape[0]
    if n_pad == n:
        return x
    reps = [x[-1:]] * (n_pad - n)
    return np.concatenate([x, *reps]) if isinstance(x, np.ndarray) else torch.cat([x, *reps])


def extract_sharded_batch(step_fn: Callable, batch, mesh: DeviceMesh) -> dict:
    """Run ``step_fn`` on this rank's rows of ``batch`` (the whole host
    batch on every rank, padded by repeating its last row to a multiple
    of the 'data' axis) and return its {name: (rows, ...) tensor} outputs
    all-gathered in global row order, the padding removed."""
    n, ndev = len(batch), axis_size(mesh)
    per, piece = padded_piece(n, ndev, mesh.get_local_rank("data"))
    out = step_fn(_pad_rows(batch, per * ndev)[piece])
    group = mesh.get_group("data")
    return {name: all_gather_cat(t, group)[:n] for name, t in out.items()}


def mesh_batch_size(batch_size: int, mesh: DeviceMesh | None) -> int:
    """``batch_size`` rounded up to a multiple of the mesh's 'data' axis
    (12 → 16 on 8 ranks), so that full batches split evenly; unchanged
    without a mesh."""
    ndev = axis_size(mesh)
    return -(-int(batch_size) // ndev) * ndev


def shard_iterations(fn: Callable, idx: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Bootstrap iterations over 'data': ``idx`` (B, m_sub) index sets
    padded with its first rows to a multiple of the axis, ``fn`` on this
    rank's contiguous slice → (..., B_local) scores, all-gathered along
    the last axis in iteration order, the padding removed. Iterations are
    independent, so each one's score is the single-process one."""
    B, ndev = idx.shape[0], axis_size(mesh)
    pad = (-B) % ndev
    idx_p = torch.cat([idx, idx[:pad]]) if pad else idx
    _, piece = padded_piece(idx_p.shape[0], ndev, mesh.get_local_rank("data"))
    scores = fn(idx_p[piece])
    return all_gather_cat(scores, mesh.get_group("data"), dim=-1)[..., :B]


def shards_iterations(mesh: DeviceMesh | None, n_iterations: int) -> bool:
    """The JAX package's rule for taking the sharded bootstrap: a mesh
    whose 'data' axis has more than one rank and no more ranks than
    iterations."""
    ndev = axis_size(mesh)
    return ndev > 1 and n_iterations >= ndev
