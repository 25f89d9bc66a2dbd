"""Spans, tracing and phase timing (port of ``visreps_tpu/core/profiling.py``,
with spans added).

  * ``span(name, items=0, **counts)`` — a context manager around one
    region of the program's work; spans nest, each under the span open
    around it. ``evals.eval`` opens the root, ``eval_span()``, which
    starts new per-name totals (``totals()``, a ``PhaseTimer``) under a
    new eval id. A span adds its host seconds and items to those totals
    and yields a ``Span`` whose ``seconds`` hold its own duration after
    the block. While a ``torch.profiler`` is active, every span but the
    root (in a trace it would name every idle gap) also enters
    ``record_function(name)``, so the trace shows it. With neither a
    profiler nor recording, a span is two clock reads and a dict update.
  * ``recording()`` — while it is open, every span also appends a record
    (``id``, ``parent``, ``eval``, ``name``, ``start_ns`` / ``end_ns`` by
    ``time.perf_counter_ns``, ``items``, ``counts``) and, where CUDA is
    initialised, records a pair of timing events on the current stream.
    ``take_spans()`` returns the
    closed records since the last take, each with ``device_s``: the
    stream's seconds from the span's start event to its end event (the
    device time of the span's work while the host keeps the stream fed;
    idle time included where it does not), or on the CPU the host
    duration. Events are read only there, never while the spans run.
  * ``trace(log_dir)`` — context manager around ``torch.profiler``
    (CPU activity, and CUDA where a card is present) that writes one Chrome trace JSON into ``log_dir`` on exit; it
    yields that file's path. Open it in Perfetto (ui.perfetto.dev) or
    chrome://tracing, where the spans are ``user_annotation`` events on
    the kernels' clock, or read it with ``summarize_trace``.
  * ``summarize_trace(path)`` — the device's busy share over the traced
    window (the union of kernel, memcpy and memset intervals), the
    device operations that took the most time, and the longest idle gaps
    with the host operation or span that ran across each.
  * ``PhaseTimer`` — per-phase wall-clock and item-throughput totals (an
    eval's spans, or phases timed with ``phase``), printed as the JAX
    package's summary table.

Spans are opened by the thread that runs the eval.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from visreps_tpu_torch.core.logging import rprint

#: Trace event categories of work on the device (kineto's names).
DEVICE_CATEGORIES = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
#: Trace event categories of host-side operations.
HOST_CATEGORIES = frozenset({"cpu_op", "user_annotation"})
#: Records kept between takes; the oldest are dropped beyond it.
MAX_RECORDS = 1 << 16


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

    def add(self, name: str, seconds: float, items: int = 0) -> None:
        secs, count = self.phases.get(name, (0.0, 0))
        self.phases[name] = (secs + seconds, count + items)

    def seconds(self, name: str) -> float:
        return self.phases.get(name, (0.0, 0))[0]

    @contextlib.contextmanager
    def phase(self, name: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0, items)

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


# ── spans ──
@dataclass
class Span:
    """One span as the code inside it sees it: ``items`` and ``counts`` may
    be added to inside the block; ``seconds`` (host) is set when it ends."""

    name: str
    items: int = 0
    counts: dict = field(default_factory=dict)
    seconds: float = 0.0


class _Recorder:
    """The process's spans: the current eval's totals and id, and while
    recording the open records (innermost last) and those not yet taken."""

    def __init__(self):
        self.totals = PhaseTimer()
        self.eval_id = 0
        self.evals: list[int] = []
        self.depth = 0
        self.next_id = 0
        self.open: list[dict] = []
        self.records: collections.deque = collections.deque(maxlen=MAX_RECORDS)


_REC = _Recorder()


@contextlib.contextmanager
def _span(name: str, items: int, counts: dict, annotate: bool):
    s = Span(name, items, counts)
    ann = (torch.profiler.record_function(name)
           if annotate and torch._C._autograd._profiler_enabled() else contextlib.nullcontext())
    rec = events = None
    if _REC.depth:
        rec = {"id": _REC.next_id, "parent": _REC.open[-1]["id"] if _REC.open else None,
               "eval": _REC.evals[-1] if _REC.evals else None, "name": name,
               "start_ns": None, "end_ns": None, "items": items, "counts": counts}
        _REC.next_id += 1
        if torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            rec["_events"] = events
        _REC.open.append(rec)
        _REC.records.append(rec)
    with ann:
        if events:
            events[0].record()
        t0 = time.perf_counter_ns()
        try:
            yield s
        finally:
            if events:
                events[1].record()
            t1 = time.perf_counter_ns()
            s.seconds = (t1 - t0) / 1e9
            _REC.totals.add(name, s.seconds, s.items)
            if rec is not None:
                _REC.open.pop()
                rec.update(start_ns=t0, end_ns=t1, items=s.items)


def span(name: str, items: int = 0, **counts):
    """A span of the program's work named ``name``, under the span open
    around it; yields its ``Span``. ``items`` (stimuli, rows) go into the
    totals and the record, ``counts`` (bytes) into the record."""
    return _span(name, items, counts, True)


@contextlib.contextmanager
def eval_span():
    """The root span ``eval`` of one eval: new totals and a new eval id,
    which every span recorded inside it carries. It enters no
    ``record_function``."""
    _REC.eval_id += 1
    _REC.evals.append(_REC.eval_id)
    _REC.totals = PhaseTimer()
    try:
        with _span("eval", 0, {}, False) as s:
            yield s
    finally:
        _REC.evals.pop()


def totals() -> PhaseTimer:
    """The current (or last) eval's seconds and items per span name."""
    return _REC.totals


@contextlib.contextmanager
def recording():
    """Record every span opened inside the block (nestable). Records not
    taken (``take_spans``) when the outermost block ends are dropped."""
    _REC.depth += 1
    try:
        yield
    finally:
        _REC.depth -= 1
        if not _REC.depth:
            _REC.records.clear()


def take_spans() -> list[dict]:
    """The records of the spans closed since the last take, in the order
    they opened, each with ``device_s``; the records of open spans stay
    for a later take. Waits for each CUDA span's end event."""
    done = [r for r in _REC.records if r["end_ns"] is not None]
    still_open = [r for r in _REC.records if r["end_ns"] is None]
    _REC.records.clear()
    _REC.records.extend(still_open)
    for r in done:
        events = r.pop("_events", None)
        if events is None:
            r["device_s"] = (r["end_ns"] - r["start_ns"]) / 1e9
        else:
            events[1].synchronize()
            r["device_s"] = events[0].elapsed_time(events[1]) / 1e3
    return done
