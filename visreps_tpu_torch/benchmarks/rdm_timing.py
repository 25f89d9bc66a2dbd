#!/usr/bin/env python3
"""Time one checkout's RDM kernel on the card at the eval's RDM shapes.

    python3 visreps_tpu_torch/benchmarks/rdm_timing.py [--root DIR] [--label NAME]

``--root`` imports ``visreps_tpu_torch`` from DIR (default: this
checkout), so that another version of the kernel — a parent commit
unpacked with ``git archive`` into a git-ignored directory — is timed
with the same code. The rows and the timing are this checkout's
``chip_smoke.py``'s (``random_rows``, ``time_kernel``), so these numbers
and chip_smoke's measure the same thing. Run the versions in turns in
one run on one card (parent, change, change, parent). Prints the card's
name and power limit, then one JSON line per shape: the (1000, d) f32
RDMs of the AlexNet NSD eval (the 14 SRP taps at d = 4096, the neural
RDMs at 512 voxels, and the exact phase-2 layers' widths), and the
(10,000, 4096) RDMs of the kernel's one-split route.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
SHAPES = [(1000, d, "float32") for d in (4096, 512, 193600, 139968, 64896, 43264)] + [
    (10000, 4096, "float32"), (10000, 4096, "bfloat16")]


def _chip_smoke():
    """This checkout's chip_smoke.py, loaded by path (DIR may hold its own)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", CHECKOUT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(CHECKOUT))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from visreps_tpu_torch.ops import rdm_kernel

    if not torch.cuda.is_available():
        print("rdm_timing: CUDA is not available", file=sys.stderr)
        return 1
    smoke = _chip_smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, d, dtype in SHAPES:
        xc, std = smoke.random_rows(n, d, dtype, gen)
        ms, host_ms = smoke.time_kernel(xc, std)
        print(json.dumps({"label": args.label, "source": str(rdm_kernel.SOURCE), "n": n,
                          "d": d, "dtype": dtype, "iters": smoke.timing_iters(n, d),
                          "ms": ms, "host_ms": host_ms}), flush=True)
        del xc, std
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
