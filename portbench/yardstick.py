"""The benchmark's yardstick: the card's peaks, the operations and bytes
of each piece of work, and the arithmetic that turns a profiler trace
into busy and idle time. Frozen here so that a later change to the
program cannot move it.

Sources of the frozen parts:
  * ``BOUND_ROUTE``, ``FMA_PEAK_OPS``, ``MEM_BYTES_PER_S``,
    ``TF32_PEAK_OPS`` and ``rdm_bound_s``: ``chip_smoke.py`` (``bound``);
  * ``kfold_bounds``: ``visreps_tpu_torch/ops/ridge.py`` (``_kfold_bounds``);
    ``wood_cv_ops``, ``ridge_ops``, ``ops_bound``: ``chip_smoke.py``;
  * ``summarize_trace``: ``visreps_tpu_torch/core/profiling.py``.

Peaks are NVIDIA's data sheet for one H100 SXM, dense, at 700 W.
"""
from __future__ import annotations

import json
from pathlib import Path

# The RDM's bound takes the cheapest route that meets its type's
# tolerance: f32 as three TF32 products (3xTF32), bf16 on its tensor cores.
BOUND_ROUTE = {"float32": ("3xTF32 tensor cores", 3, 495e12),
               "bfloat16": ("bf16 tensor cores", 1, 989e12)}
FMA_PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
TF32_PEAK_OPS = 495e12
MEM_BYTES_PER_S = 3.35e12


def rdm_bound_s(n: int, d: int, dtype: str) -> float:
    """Least time of one (n, d) RDM: the n(n+1)·d operations of the
    symmetric product's upper triangle and diagonal over the route's peak,
    or the bytes (rows in, stds in, RDM out) over the memory rate,
    whichever is larger."""
    _, passes, peak = BOUND_ROUTE[dtype]
    ops = float(n) * (n + 1) * d
    nbytes = n * d * (4 if dtype == "float32" else 2) + 4 * n + 4 * n * n
    return max(passes * ops / peak, nbytes / MEM_BYTES_PER_S)


def srp_ops(d: int, k: int) -> float:
    """Operations of projecting one row of width d (2·d·k where d > k;
    a tap no wider than k is projected too, by its own d × d matrix)."""
    return 2.0 * d * min(d, k)


def forward_ops(module, image_size: int = 224) -> float:
    """Operations (2 per multiply-add) of one image's forward through
    ``module``, counted by ``torch.utils.flop_counter`` on a meta copy."""
    import copy

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    meta = copy.deepcopy(module).to("meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        meta(torch.empty((1, 3, image_size, image_size), device="meta"))
    return float(counter.get_total_flops())


def kfold_bounds(n: int, n_folds: int) -> list[tuple[int, int]]:
    """Contiguous KFold boundaries (first n % k folds one larger)."""
    sizes = [n // n_folds + (1 if i < n % n_folds else 0) for i in range(n_folds)]
    bounds, start = [], 0
    for s in sizes:
        bounds.append((start, start + s))
        start += s
    return bounds


def wood_cv_ops(n: int, d: int, v: int, n_alphas: int = 20,
                n_folds: int = 5) -> tuple[float, float]:
    """Operations of the Woodbury CV sweep at these shapes: (the v-wide
    products that ``high`` runs on TF32, the f32 rest)."""
    nvs = [stop - start for start, stop in kfold_bounds(n, n_folds)]
    sweep = sum(n_alphas * 2.0 * (nv * d * v + 2 * nv * nv * v) for nv in nvs)
    f32 = 2.0 * d * d * v + sum(2.0 * (d * d * nv + d * nv * v)
                                + n_alphas * 2.0 * (nv * nv * d + nv ** 3) for nv in nvs)
    return sweep, f32


def ridge_ops(n: int, d: int, v: int, n_pred: int) -> tuple[float, float]:
    """Operations of one Woodbury RidgeCV fit and prediction: the sweep
    plus, in f32, the Gram, its eigh (≈ 10/3·d³), xᵀy, the weights and the
    prediction of n_pred rows."""
    sweep, f32 = wood_cv_ops(n, d, v)
    return sweep, f32 + 2.0 * (n * d * d + n * d * v + 2 * d * d * v + n_pred * d * v) \
        + 10 / 3 * d ** 3


def ops_bound(fits: list, precision: str) -> float:
    """Least seconds of ``fits`` [(n, d, v, n_pred), ...]: at ``highest``
    every operation over the f32 FMA peak, otherwise the sweep over the
    TF32 peak and the rest over the f32 peak."""
    sweep = f32 = 0.0
    for fit in fits:
        a, b = ridge_ops(*fit)
        sweep, f32 = sweep + a, f32 + b
    if precision == "highest":
        return (sweep + f32) / FMA_PEAK_OPS["float32"]
    return sweep / TF32_PEAK_OPS + f32 / FMA_PEAK_OPS["float32"]


# ── traces ──
DEVICE_CATEGORIES = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATEGORIES = frozenset({"cpu_op", "user_annotation"})


def _merge(intervals):
    merged: list[list[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(s, e) for s, e in merged]


def _host_op_across(gap, host):
    """The host event overlapping ``gap`` the most; of equal overlaps the
    shortest (the innermost op)."""
    best, key = None, None
    for ev in host:
        overlap = min(gap[1], ev["ts"] + ev["dur"]) - max(gap[0], ev["ts"])
        if overlap > 0 and (key is None or (overlap, -ev["dur"]) > key):
            best, key = ev, (overlap, -ev["dur"])
    return None if best is None else best["name"]


def summarize_trace(path: str | Path, top: int = 10) -> dict:
    """A Chrome trace's window (first to last event of any kind), the
    device's busy time (the union of kernel, memcpy and memset intervals),
    device time per operation name, the ``top`` operations by time and
    the ``top`` longest idle gaps inside the window, each named by the
    host operation that ran across it. Times in seconds."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    spans = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
    if not spans:
        raise ValueError(f"{path} holds no timed events")
    for e in spans:
        e["ts"], e["dur"] = float(e["ts"]), float(e["dur"])
    start = min(e["ts"] for e in spans)
    end = max(e["ts"] + e["dur"] for e in spans)
    device = [e for e in spans if str(e.get("cat", "")).lower() in DEVICE_CATEGORIES]
    host = [e for e in spans if str(e.get("cat", "")).lower() in HOST_CATEGORIES]
    busy = _merge([(e["ts"], e["ts"] + e["dur"]) for e in device])
    per_op: dict[str, float] = {}
    for e in device:
        per_op[e["name"]] = per_op.get(e["name"], 0.0) + e["dur"] / 1e6
    edges = [start, *(x for iv in busy for x in iv), end]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {
        "window_s": (end - start) / 1e6,
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "op_s": per_op,
        "top_ops": sorted(per_op.items(), key=lambda kv: -kv[1])[:top],
        "gaps": [(_host_op_across(g, host) or "no host op", (g[1] - g[0]) / 1e6)
                 for g in gaps],
    }
