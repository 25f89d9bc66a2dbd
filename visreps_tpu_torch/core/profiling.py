"""Tracing and phase timing (port of ``visreps_tpu/core/profiling.py``).

  * ``trace(log_dir)`` — context manager around ``torch.profiler``
    (CPU activity, and CUDA where a card is present) that writes one
    Chrome trace JSON into ``log_dir`` on exit; it yields that file's
    path. Open it in Perfetto (ui.perfetto.dev) or chrome://tracing, or
    read it with ``summarize_trace``.
  * ``summarize_trace(path)`` — the device's busy share over the traced
    window (the union of kernel, memcpy and memset intervals), the
    device operations that took the most time, and the longest idle gaps
    with the host operation that ran across each.
  * ``PhaseTimer`` — per-phase wall-clock and item-throughput counters,
    printed as the JAX package's summary table.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

from visreps_tpu_torch.core.logging import rprint

#: Trace event categories of work on the device (kineto's names).
DEVICE_CATEGORIES = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
#: Trace event categories of host-side operations.
HOST_CATEGORIES = frozenset({"cpu_op", "user_annotation"})


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile the block; yields the path of the Chrome trace that is
    written into ``log_dir`` when the block exits (also on an error)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    path = log_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof = profile(activities=activities)
    prof.start()
    try:
        yield path
    finally:
        prof.stop()
        prof.export_chrome_trace(str(path))
        rprint(f"Profiler trace written to {path}", style="info")


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(s, e) for s, e in merged]


def _host_op_across(gap: tuple[float, float], host: list[dict]) -> dict | None:
    """The host event overlapping ``gap`` the most; of equal overlaps the
    shortest (the innermost op)."""
    best, key = None, None
    for ev in host:
        overlap = min(gap[1], ev["ts"] + ev["dur"]) - max(gap[0], ev["ts"])
        if overlap > 0 and (key is None or (overlap, -ev["dur"]) > key):
            best, key = ev, (overlap, -ev["dur"])
    if best is None:
        return None
    return {"name": best["name"], "overlap_ms": key[0] / 1e3}


def summarize_trace(path: str | Path, top: int = 5) -> dict:
    """Read a Chrome trace (``trace``'s output). Returns ``window_ms``
    (first to last event of any kind), ``device_busy_ms`` (the union of
    the device's kernel, memcpy and memset intervals), ``busy_share``
    (their ratio; 0 with no device event), ``n_device_events``,
    ``top_ops`` (the ``top`` device operations by summed time: name, ms,
    count) and ``gaps`` (the ``top`` longest idle stretches of the
    device inside the window, each with ``host_op``, the host operation
    that ran across it, or None)."""
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
    busy_us = sum(e - s for s, e in busy)

    per_op: dict[str, list] = {}
    for e in device:
        acc = per_op.setdefault(e["name"], [0.0, 0])
        acc[0] += e["dur"]
        acc[1] += 1
    top_ops = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:top]

    edges = [start, *(x for iv in busy for x in iv), end]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    window_us = end - start
    return {
        "window_ms": window_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "busy_share": busy_us / window_us if window_us > 0 else 0.0,
        "n_device_events": len(device),
        "top_ops": [{"name": name, "ms": us / 1e3, "count": n} for name, (us, n) in top_ops],
        "gaps": [{"start_ms": (s - start) / 1e3, "ms": (e - s) / 1e3,
                  "host_op": _host_op_across((s, e), host)} for s, e in gaps],
    }


@dataclass
class PhaseTimer:
    """Accumulates (wall seconds, items) per named phase."""

    phases: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            secs, count = self.phases.get(name, (0.0, 0))
            self.phases[name] = (secs + dt, count + items)

    def summary(self) -> str:
        lines = [f"{'phase':<28}{'seconds':>10}{'items':>10}{'items/s':>12}"]
        total = 0.0
        for name, (secs, items) in self.phases.items():
            rate = f"{items / secs:>12.1f}" if items and secs > 0 else f"{'—':>12}"
            lines.append(f"{name:<28}{secs:>10.2f}{items:>10}{rate}")
            total += secs
        lines.append(f"{'TOTAL':<28}{total:>10.2f}")
        return "\n".join(lines)

    def report(self):
        rprint(self.summary(), style="info")
