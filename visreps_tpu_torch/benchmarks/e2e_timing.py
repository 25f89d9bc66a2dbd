#!/usr/bin/env python3
"""Time one checkout's e2e NSD RSA eval on the card.

    python3 visreps_tpu_torch/benchmarks/e2e_timing.py [--root DIR] [--runs N] [--label NAME]

``--root`` imports ``visreps_tpu_torch`` and ``chip_smoke.py`` from DIR
(default: this checkout), so that another version — a parent commit
unpacked with ``git archive`` into a git-ignored directory — runs its
own e2e phase (``chip_smoke.phase_e2e``: the eval through
``run.main`` on chip_smoke's 3,000-stimulus fixture, with its checks).
The process builds the RDM kernel, writes the fixture, then runs the
eval ``--runs`` times; the first run of a process is cold. Run the
versions in turns in one run on one card (parent, change, change,
parent). Prints the card's name and power limit, then per run one JSON
line: the label, the run's index, its wall and phase times.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(CHECKOUT))
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("e2e_timing: CUDA is not available", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke.phase_build()
    tmp = Path(tempfile.mkdtemp(prefix="visreps_e2e_timing_"))
    try:
        meta = smoke.nsd_fixture(tmp)
        for i in range(args.runs):
            run = smoke.phase_e2e(meta)
            print(json.dumps({"label": args.label, "run": i, "seconds": run["seconds"],
                              "phase_times_s": run["phases"]}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
