"""Grid sweep runner: the Cartesian product of list-valued parameters
(port of ``visreps_tpu/runners/base_runner.py``).

A grid JSON is a param dict or a list of them; in each, LIST values are
swept (``itertools.product``), scalars are fixed, and nested dicts
flatten to dot-notation overrides. Each combo launches ``python -m
visreps_tpu_torch.run`` in a subprocess, on the card, or on the CPU when
``device="cpu"`` is passed through (``--device``). ``jobs > 1`` runs
combos in concurrent subprocesses; ``env_per_job(idx)`` may add to each
job's environment; failed combos are retried ``retries`` times (runs
are idempotent: results.db rows are replaced).
"""
from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from visreps_tpu_torch.core.logging import rprint

RUN_MODULE = "visreps_tpu_torch.run"


def _flatten(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def load_param_grid(grid_path: str | Path) -> list[dict]:
    """Expand a grid JSON into a list of override dicts."""
    with open(grid_path) as f:
        groups = json.load(f)
    if isinstance(groups, dict):
        groups = [groups]

    combos: list[dict] = []
    for group in groups:
        flat = _flatten(group)
        sweep_keys = [k for k, v in flat.items() if isinstance(v, list)]
        fixed = {k: v for k, v in flat.items() if not isinstance(v, list)}
        if sweep_keys:
            for values in itertools.product(*(flat[k] for k in sweep_keys)):
                combo = dict(fixed)
                combo.update(dict(zip(sweep_keys, values)))
                combos.append(combo)
        else:
            combos.append(fixed)
    return combos


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return json.dumps(v) if isinstance(v, (list, dict)) else str(v)


def exit_code(codes: list[int]) -> int:
    """One exit code for a sweep: 0 when every job exited 0, else the
    largest |code| (a job killed by a signal has a negative code)."""
    return max((abs(c) for c in codes), default=0)


class ExperimentRunner:
    """Run every grid combo as a subprocess of ``visreps_tpu_torch.run``."""

    def __init__(self, mode: str, grid_path: str | Path | None = None,
                 config: str | None = None, extra_overrides: dict | None = None,
                 jobs: int = 1, dry_run: bool = False, env_per_job=None,
                 retries: int = 0, device: str | None = None):
        self.mode = mode
        self.config = config
        self.combos = load_param_grid(grid_path) if grid_path else [{}]
        self.extra_overrides = extra_overrides or {}
        self.jobs = jobs
        self.dry_run = dry_run
        self.env_per_job = env_per_job  # callable(job_idx) -> env dict update
        self.retries = retries
        self.device = device  # None: the card

    def _command(self, combo: dict) -> list[str]:
        overrides = {**combo, **self.extra_overrides}
        cmd = [sys.executable, "-m", RUN_MODULE, "--mode", self.mode]
        if self.config:
            cmd += ["--config", self.config]
        if overrides:
            cmd += ["--override"] + [f"{k}={_fmt_value(v)}" for k, v in overrides.items()]
        if self.device:
            cmd += ["--device", self.device]
        return cmd

    def _run_one(self, idx_combo):
        idx, combo = idx_combo
        cmd = self._command(combo)
        rprint(f"[{idx + 1}/{len(self.combos)}] {' '.join(cmd)}", style="setup")
        if self.dry_run:
            return 0
        env = dict(os.environ)
        if self.env_per_job:
            env.update(self.env_per_job(idx))
        rc = subprocess.run(cmd, env=env).returncode
        for attempt in range(self.retries):
            if rc == 0:
                break
            rprint(f"combo {idx} failed (rc={rc}); retry {attempt + 1}/{self.retries}",
                   style="warning")
            rc = subprocess.run(cmd, env=env).returncode
        return rc

    def run_all(self) -> list[int]:
        if self.jobs <= 1:
            return [self._run_one(x) for x in enumerate(self.combos)]
        with ThreadPoolExecutor(max_workers=self.jobs) as pool:
            return list(pool.map(self._run_one, enumerate(self.combos)))
