#!/usr/bin/env python3
"""``--procs 2`` as the first launch of a checkout on the card: with no
built kernel, both workers build it at once.

    python3 visreps_tpu_torch/benchmarks/procs_first_launch.py

Removes this checkout's ``visreps_tpu_torch/_build/``, writes
``chip_smoke.py``'s 3,000-stimulus e2e fixture under a temporary
directory, and runs ``python -m visreps_tpu_torch.run --mode eval --procs
2`` in chip_smoke's e2e configuration (2 subjects: one per worker) into a
fresh results.db. Prints the card's name and power limit, then one JSON
line: the exit code, the seconds, the results.db rows, the libraries in
``_build/`` and whether a worker reported "database is locked". Exits
with the CLI's code.
"""
from __future__ import annotations

import importlib.util
import json
import os
import shutil
import sqlite3
import subprocess
import sys
import tempfile
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


def main() -> int:
    sys.path.insert(0, str(CHECKOUT))
    import torch

    if not torch.cuda.is_available():
        print("procs_first_launch: CUDA is not available", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", CHECKOUT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    build = CHECKOUT / "visreps_tpu_torch" / "_build"
    shutil.rmtree(build, ignore_errors=True)
    tmp = Path(tempfile.mkdtemp(prefix="visreps_procs_first_launch_"))
    try:
        smoke.nsd_fixture(tmp)
        db = tmp / "procs.db"
        env = dict(os.environ, VISREPS_RESULTS_DB=str(db), PYTHONPATH=str(CHECKOUT))
        subjects = list(range(smoke.E2E["n_subjects"]))
        regions = smoke.NSD_REGIONS[: smoke.E2E["n_regions"]]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "visreps_tpu_torch.run", "--mode", "eval", "--procs", "2",
             "--config", str(CHECKOUT / "configs/eval/base.json"),
             "--override", *smoke.rsa_overrides(smoke.E2E_SOURCE, subjects, regions)],
            env=env, cwd=CHECKOUT, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        with sqlite3.connect(str(db)) as conn:
            rows = conn.execute("SELECT COUNT(*) FROM results").fetchone()[0]
        print(json.dumps({"rc": proc.returncode, "seconds": seconds, "db_rows": rows,
                          "build": sorted(p.name for p in build.glob("*.so")),
                          "database_locked": "database is locked" in proc.stderr,
                          "stderr_tail": proc.stderr[-2000:]}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
