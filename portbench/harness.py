"""One run of one cell: set-up, the measured window, the traced eval, the
per-layer readers and the comparison with the plain reference.

The cell's files are found by name (``cells.py``): the model, the
dataset and the analysis each give their part of the eval's Config and
of the run's environment, and the analysis gives the reference and the
comparison. ``run_cell`` drives the program, the package
``visreps_tpu_torch``, through ``evals.eval`` with the Config that
``python -m visreps_tpu_torch.run --mode eval`` would build from the same
overrides.
"""
from __future__ import annotations

import copy
import gc
import json
import math
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from portbench import cells, yardstick

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "visreps_tpu"})


def load_reader(name: str, root: Path = cells.ROOT):
    """``metrics/<name>.py``'s ``read(ctx)``."""
    return cells.find("metrics", name, root).read


def overrides(cell: dict, seed: int, extra: dict | None = None) -> list[str]:
    """The ``--override`` list of the eval a user would run for ``cell``:
    the model's, the dataset's and the analysis's keys, the
    configuration's batch and SRP, the mix's transfer and retention, then
    ``extra``. ``seed`` draws the
    weights and the SRP matrices; the eval's own ``seed`` (1–3 by the
    validator) only names the run."""
    keys = {"mode": "eval", "seed": 1, "srp_seed": seed, "srp_k": cell["srp_k"],
            "batchsize": cell["batchsize"], "log_expdata": True, "verbose": False}
    for k in ("uint8_transfer", "acts_retain"):
        if k in cell:
            keys[k] = cell[k]
    keys.update(cells.model(cell).overrides(cell))
    keys.update(cells.dataset(cell).overrides(cell))
    keys.update(cells.analysis(cell).overrides(cell))
    keys.update(extra or {})
    return [f"{k}={v if isinstance(v, str) else json.dumps(v, separators=(',', ':'))}"
            for k, v in keys.items()]


@dataclass
class Context:
    """What a per-layer reader may read: the cell, each eval of the window
    (its phase seconds, its wall seconds, and in a traced run what each
    probe recorded, under the probe's name), the window's seconds and the
    traced eval's trace summary."""
    cell: dict
    window_s: float
    evals: list = field(default_factory=list)
    trace: dict | None = None
    traced_eval: int | None = None

    def untraced(self) -> list:
        """The window's evals that ran without the profiler (all of them
        where the profiled eval was the only one)."""
        rest = [e for i, e in enumerate(self.evals) if i != self.traced_eval]
        return rest or self.evals

    def per_eval(self, key: str) -> float | None:
        """Seconds per eval of phase ``key``: the sum over the untraced
        evals of the window over their number."""
        evals = self.untraced()
        vals = [e["phases"][key] for e in evals if key in e["phases"]]
        return sum(vals) / len(evals) if vals and len(vals) == len(evals) else None


class _Probes:
    """Every probe of ``probes/``, installed for the life of this object."""

    def __init__(self, root):
        self.probes = {n: cells.find("probes", n, root).install() for n in cells.probe_names(root)}

    def take(self) -> dict:
        return {n: p.take() for n, p in self.probes.items()}

    def close(self):
        for p in self.probes.values():
            p.close()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def prepare(cell: dict, work: Path):
    """Point the program at this run's files (results.db under ``work``,
    the cell's fixture, written on a checkout's first run) and import it;
    returns ``visreps_tpu_torch.evals``."""
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    os.environ["VISREPS_RESULTS_DB"] = str(work / "results.db")
    from visreps_tpu_torch import evals  # core.db reads VISREPS_RESULTS_DB at import

    os.environ.update(cells.dataset(cell).ensure(cell, Path(cell["fixture_dir"])))
    return evals


def eval_config(cell: dict, seed: int, device: str, work: Path):
    """Install this seed's weights where the eval loads them from and build
    the eval's Config as ``run.main`` does."""
    from visreps_tpu_torch.core.config import load_config
    from visreps_tpu_torch.run import validate_config

    os.environ.update(cells.model(cell).install(cell, seed, device, work))
    return validate_config(load_config(str(cells.ROOT / "configs" / "eval" / "base.json"),
                                       overrides(cell, seed)))


def warmup_config(cell: dict, seed: int):
    """The warm-up eval's Config: the dataset's cut of the cell's eval,
    with the weights already installed."""
    from visreps_tpu_torch.core.config import load_config
    from visreps_tpu_torch.run import validate_config

    return validate_config(load_config(
        str(cells.ROOT / "configs" / "eval" / "base.json"),
        overrides(cell, seed, cells.dataset(cell).warmup_overrides(cell))))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None, out=sys.stdout) -> int:
    """One run; prints the result line on ``out``. Returns the exit code."""
    t_start = time.perf_counter() if t_start is None else t_start
    work = Path(os.environ.get("TMPDIR") or tempfile.gettempdir()) / "portbench"
    evals = prepare(cell, work)
    cfg = eval_config(cell, seed, device, work)

    def one_eval(c=cfg):
        out_ = evals.eval(copy.deepcopy(c), device=device)
        _sync(device)
        return out_, dict(evals.LAST_PHASE_TIMES)

    one_eval(warmup_config(cell, seed))  # every shape of the cell, the kernel's build
    gc.collect()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    probes = _Probes(cell["root"]) if trace else None
    runs, ctx = [], Context(cell=cell, window_s=0.0)
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    while True:
        t_eval = time.perf_counter()
        if trace and ctx.trace is None:
            results, phases, ctx.trace = _traced(one_eval, work, device)
            ctx.traced_eval = len(runs)
        else:
            results, phases = one_eval()
        runs.append(results)
        ctx.evals.append({"phases": phases, "wall_s": time.perf_counter() - t_eval,
                          **(probes.take() if probes else {})})
        if time.perf_counter() - t_window >= seconds:
            break
    ctx.window_s = time.perf_counter() - t_window
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if probes:
        probes.close()
    found = _forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded in this process: {found}", file=sys.stderr)
        return 3

    n_stim = cells.dataset(cell).n_stimuli(cell)
    metrics = {}
    if trace:
        for m in cell["per_layer"]:
            value = load_reader(m["name"], cell["root"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"images_per_s": n_stim * len(runs) / ctx.window_s,
               "peak_mem_gb": peak / 1e9, "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    analysis = cells.analysis(cell)
    check = analysis.check(cell, seed, device, {"program": runs})["program"]
    for k in analysis.NUMBERS:
        print(f"check {k} {check['readings'][k]!r} limit {cell['limits'][k]!r}",
              file=sys.stderr)
    line = {"correct": check["correct"], "attempted": check["attempted"],
            "failed": check["failed"], "metrics": metrics,
            "device": {"platform": "gpu" if device == "cuda" else device,
                       "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                       "count": int(cell["chips"]), "memory_peak_bytes": int(peak)},
            "evals": len(runs), "window_s": ctx.window_s,
            "eval_s": [e["wall_s"] for e in ctx.evals],
            "eval_phases": [{k: round(v, 4) for k, v in e["phases"].items()} for e in ctx.evals]}
    if trace and ctx.trace is not None:
        line["device"]["busy_s"] = ctx.trace["busy_s"]
        line["device"]["window_s"] = ctx.trace["window_s"]
        line["breakdown"] = {"device_ops": [list(x) for x in ctx.trace["top_ops"]],
                             "idle_gaps": [list(x) for x in ctx.trace["gaps"]]}
    line["check"] = {k: {"value": _num(check["readings"][k]), "limit": cell["limits"][k]}
                     for k in analysis.NUMBERS}
    print(json.dumps(line), file=out, flush=True)
    return 0


def _num(v: float):
    return v if math.isfinite(v) else "inf"


def _traced(one_eval, work: Path, device):
    """One eval under ``torch.profiler``; its trace's summary."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    path = work / "trace.json"
    with profile(activities=acts) as prof:
        results, phases = one_eval()
    prof.export_chrome_trace(str(path))
    summary = yardstick.summarize_trace(path)
    path.unlink()
    return results, phases, summary
