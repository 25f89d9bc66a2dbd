"""The plain reference's shared pieces, in PyTorch and NumPy: the model's
forward and the SRP store as the eval's extraction makes them, RDMs,
ranks, Pearson and the bootstrap's index sets. An analysis file
(``analyses/<reference>.py``) builds its reference from them.

Nothing here imports the program (neither ``visreps_tpu_torch`` nor the
JAX package) or takes anything the program made: the weights are made
again from the seed (``models/<model>.py``, ``weights.py``), the
projections from the frozen seeding rule (``srp_rule.py``), the inputs
from the fixture (``datasets/<dataset>.py``).

RDMs are 1 − Pearson correlation of centred rows, std √(mean square +
1e-12) (1 where below 1e-11), the correlation clamped to [−1, 1], the
diagonal 0. Rows are computed in blocks so that the whole fits the card
after the program's state is freed. ``tf32=True`` runs the forward with
TF32 on: the control, the same reference in the nearest precision below
the configuration's float32.
"""
from __future__ import annotations

from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from portbench import cells, srp_rule, weights

_COLS = 32768  # columns per f64 block of a Gram
#: Bytes of bf16 store from which the eval keeps only the selection rows
#: and under which it stores on the card (``evals.STORE_BUDGET_BYTES``).
STORE_BUDGET_BYTES = 9e9


@contextmanager
def _tf32(enabled: bool):
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def rdm_triangle(x: torch.Tensor) -> torch.Tensor:
    """(n, d) rows (any float type) → the (n(n−1)/2,) f64 strict upper
    triangle, row-major, of their correlation RDM."""
    n, d = x.shape
    mu = torch.zeros(n, dtype=torch.float64, device=x.device)
    for c in range(0, d, _COLS):
        mu += x[:, c:c + _COLS].to(torch.float64).sum(1)
    mu /= d
    gram = torch.zeros((n, n), dtype=torch.float64, device=x.device)
    ss = torch.zeros(n, dtype=torch.float64, device=x.device)
    for c in range(0, d, _COLS):
        xb = x[:, c:c + _COLS].to(torch.float64) - mu[:, None]
        gram += xb @ xb.T
        ss += (xb * xb).sum(1)
    std = torch.sqrt(ss / d + 1e-12)
    std = torch.where(std < 1e-11, torch.ones_like(std), std)
    corr = (gram / d / (std[:, None] * std[None, :] + 1e-12)).clamp(-1.0, 1.0)
    iu = torch.triu_indices(n, n, offset=1, device=x.device)
    return 1.0 - corr[iu[0], iu[1]]


def ordinal_ranks(v: torch.Tensor) -> torch.Tensor:
    return torch.argsort(torch.argsort(v, dim=-1, stable=True), dim=-1, stable=True).to(
        torch.float64)


def average_ranks(v: torch.Tensor) -> torch.Tensor:
    """1-based ranks along the last axis, ties given their mean rank."""
    sv, order = torch.sort(v, dim=-1, stable=True)
    m = v.shape[-1]
    idx = torch.arange(m, device=v.device).expand_as(sv)
    new = torch.ones_like(sv, dtype=torch.bool)
    new[..., 1:] = sv[..., 1:] != sv[..., :-1]
    start = torch.cummax(torch.where(new, idx, torch.zeros_like(idx)), dim=-1).values
    last = torch.ones_like(new)
    last[..., :-1] = new[..., 1:]
    end = torch.flip(torch.cummin(torch.flip(torch.where(last, idx, torch.full_like(idx, m)),
                                             [-1]), dim=-1).values, [-1])
    avg = (start + end).to(torch.float64) / 2.0 + 1.0
    return torch.empty_like(avg).scatter_(-1, order, avg)


def pearson(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a - a.mean(-1, keepdim=True)
    b = b - b.mean(-1, keepdim=True)
    return (a * b).sum(-1) / torch.sqrt((a * a).sum(-1) * (b * b).sum(-1))


def bootstrap_index_sets(n_test: int, n_bootstrap: int) -> np.ndarray:
    """(B, ⌊0.9 n⌋) without-replacement sets, ``RandomState(42).choice``
    per iteration."""
    rng = np.random.RandomState(42)
    return np.stack([rng.choice(n_test, size=int(n_test * 0.9), replace=False)
                     for _ in range(n_bootstrap)]).astype(np.int64)


def store_dtype(device: torch.device, n_stimuli: int, out_total: int,
                n_plan: int) -> torch.dtype:
    """The type the eval stores SRP rows in (``evals.store_plan`` with
    ``acts_retain`` and ``acts_store`` auto): bf16 on the card while the
    kept rows' bf16 store is under the budget (all rows, or only the
    plan's once the whole store would reach it), else f32 on the host."""
    n_store = n_stimuli
    if device.type == "cuda" and 2 * n_stimuli * out_total >= STORE_BUDGET_BYTES:
        n_store = min(n_plan, n_stimuli)
    small = 0 < 2 * n_store * out_total < STORE_BUDGET_BYTES
    return torch.bfloat16 if device.type == "cuda" and small else torch.float32


class Forward:
    """The cell's model with the seed's weights, on the cell's data: the
    reference's side of the eval's extraction."""

    def __init__(self, cell: dict, seed: int, device, tf32: bool = False):
        self.cell = cell
        self.seed = seed
        self.device = torch.device(device)
        self.tf32 = tf32
        self.data = cells.dataset(cell).View(cell, self.device)
        self._model = cells.model(cell)
        self.module = weights.seeded(self._model.build, seed, self.device)
        self.taps = list(cell["taps"])

    def batches(self, ids, names):
        """(first row, {tap: (B, D) f32}) for each batch of
        ``reference_batch`` of ``ids``."""
        step = int(self.cell["reference_batch"])
        for s in range(0, len(ids), step):
            with _tf32(self.tf32):
                yield s, self._model.taps(self.module, self.data.images(ids[s:s + step]), names)

    def widths(self, names, ids) -> dict:
        """{tap: width} from one forward of ``ids[:1]``."""
        return {n: t.shape[1] for n, t in
                self._model.taps(self.module, self.data.images(ids[:1]), names).items()}

    def srp_matrices(self, widths: dict) -> dict:
        """{width: the seed's projection chunks}, one per distinct width."""
        k = int(self.cell["srp_k"])
        return {d: srp_rule.matrix_chunks(d, k, self.seed, self.device)
                for d in sorted(set(widths.values()))}

    def srp_store(self, ids, widths: dict, matrices: dict, dtype) -> dict:
        """{tap: (len(ids), k) SRP rows of ``ids`` in ``dtype``}."""
        k = int(self.cell["srp_k"])
        store = {t: torch.empty((len(ids), srp_rule.out_dim(widths[t], k)), dtype=dtype,
                                device=self.device) for t in self.taps}
        for start, taps in self.batches(ids, self.taps):
            for t in self.taps:
                rows = taps.pop(t)
                store[t][start:start + rows.shape[0]] = srp_rule.project(rows, matrices[widths[t]])
        return store

    def exact(self, ids, layers) -> dict:
        """{layer: f64 RDM triangle} of the layers' full-resolution taps
        over ``ids``, in passes of at most ``reference_pass_bytes`` of f32
        rows."""
        layers = [t for t in self.taps if t in set(layers)]
        widths = self.widths(layers, ids)
        budget = float(self.cell["reference_pass_bytes"])
        groups, size = [[]], 0
        for layer in layers:
            nbytes = 4 * len(ids) * widths[layer]
            if groups[-1] and size + nbytes > budget:
                groups.append([])
                size = 0
            groups[-1].append(layer)
            size += nbytes
        out = {}
        for group in groups:
            rows = {t: torch.empty((len(ids), widths[t]), dtype=torch.float32,
                                   device=self.device) for t in group}
            for start, taps in self.batches(ids, group):
                for t in group:
                    x = taps.pop(t)
                    rows[t][start:start + x.shape[0]] = x
            for t in group:
                out[t] = rdm_triangle(rows.pop(t))
        return out
