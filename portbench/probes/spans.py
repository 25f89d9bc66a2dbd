"""Records the program's spans (``visreps_tpu_torch.core.profiling``: every
``span`` opened while ``recording()`` is open, read by ``take_spans()``)
for each eval of a ``--trace 1`` run, kept under the probe's name
``spans``; and the arithmetic the span readers share (``per_eval``).

A record is a dict: ``id``, ``parent``, ``eval``, ``name``, ``start_ns`` /
``end_ns`` (``time.perf_counter_ns``), ``items``, ``counts`` and
``device_s`` (the stream's seconds between the span's CUDA events; the
host duration on the CPU). A program without spans (no ``recording`` in
its ``core.profiling``) records nothing, and the readers return None.
"""
from __future__ import annotations

import contextlib


class _Probe:
    def __init__(self):
        from visreps_tpu_torch.core import profiling

        self.stack = contextlib.ExitStack()
        self.take_spans = getattr(profiling, "take_spans", None)
        if self.take_spans is not None:
            self.stack.enter_context(profiling.recording())

    def take(self) -> list:
        return self.take_spans() if self.take_spans is not None else []

    def close(self):
        self.stack.close()


def install():
    return _Probe()


def host_s(record: dict) -> float:
    return (record["end_ns"] - record["start_ns"]) / 1e9


def _under(records: list, root: str) -> list:
    """The records with an ancestor named ``root``."""
    by_id = {r["id"]: r for r in records}

    def inside(r):
        while r["parent"] in by_id:
            r = by_id[r["parent"]]
            if r["name"] == root:
                return True
        return False

    return [r for r in records if inside(r)]


def _value(records: list, rec: dict, of, self_time: bool) -> float:
    """``of(rec)``, less ``of`` of each of its children with ``self_time``."""
    if not self_time:
        return of(rec)
    return of(rec) - sum(of(r) for r in records if r["parent"] == rec["id"])


def per_eval(ctx, name: str, of=lambda r: r["device_s"], under: str | None = None,
             self_time: bool = False) -> float | None:
    """The sum of ``of(record)`` (self time with ``self_time``: less its
    children's) over the records named ``name`` (with an ancestor named
    ``under`` where given) of each of the window's untraced evals, over
    their number; None unless every one of those evals recorded such a
    span."""
    evals = ctx.untraced()
    sums = []
    for e in evals:
        records = e.get("spans") or []
        pool = _under(records, under) if under else records
        mine = [r for r in pool if r["name"] == name]
        if not mine:
            return None
        sums.append(sum(_value(records, r, of, self_time) for r in mine))
    return sum(sums) / len(sums) if sums else None
