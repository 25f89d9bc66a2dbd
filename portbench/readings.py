"""The readings that a cell's limits are set from, many seeds in one
process (set-up is paid once):

    python3 portbench/readings.py --workload <cell> --seeds S [S ...]
        [--control-seeds S [S ...]] [--out FILE]

For each seed: the weights from the seed, one eval of the program (the
timed path's entry, at the cell's sizes), the plain reference, and the
numbers the cell's analysis compares (``analyses/<reference>.py``) for
the program against it. For each control seed also the control (the
analysis's ``control``: for RSA the same reference with TF32 on) put in
the program's place. One JSON line per seed on standard output (and
appended to ``--out``): the seed, ``program`` and ``control`` readings,
the reference's notes, and the seconds of the eval and of the
reference.
"""
from __future__ import annotations

import argparse
import copy
import gc
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "portbench" / "_cache" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "portbench" / "_cache" / "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from portbench import cells, harness

    cell = cells.load_cell(args.workload)
    analysis = cells.analysis(cell)
    device = args.device
    work = Path(os.environ.get("TMPDIR") or tempfile.gettempdir()) / "portbench_readings"
    evals = harness.prepare(cell, work)
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        cfg = harness.eval_config(cell, seed, device, work)
        t = time.perf_counter()
        runs = [evals.eval(copy.deepcopy(cfg), device=device)] if seed in args.seeds else []
        eval_s = time.perf_counter() - t
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        control = analysis.control(cell, seed, device) if seed in args.control_seeds else None
        control_s = time.perf_counter() - t
        if device == "cuda":
            torch.cuda.empty_cache()
        sides = {k: v for k, v in (("program", runs), ("control", [control] if control else []))
                 if v}
        t = time.perf_counter()
        checked = analysis.check(cell, seed, device, sides)
        ref_s = time.perf_counter() - t
        line = {"cell": args.workload, "seed": seed, "eval_s": eval_s, "reference_s": ref_s,
                "control_s": control_s, **checked.pop("notes", {})}
        for key, r in sides.items():
            line[key] = checked[key]["readings"]
            line[key + "_layers"] = [x["layer"] for x in r[0]]
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
