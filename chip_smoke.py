#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero without the final line:

  1. build — compile the RDM kernel (csrc/rdm.cu) from this checkout.
  2. kernel — the RDM kernel against its plain torch version on the card
     at the eval's shapes and one ragged shape (n and d not multiples of
     the tile) (f32 tolerance 1e-5, bf16 3e-3 against the plain version
     on the same bf16 rows), with the kernel's time, the
     plain version's, one torch.corrcoef call's (the library yardstick)
     and the card's lower bound for the work.
  3. srp — the SRP product on the card (bf16 GEMM, f32 out) against the
     same product in f32 on widened operands (relative tolerance 1e-5).
  4. e2e — the NSD RSA eval through ``python -m visreps_tpu_torch.run``'s
     entry point on a synthetic fixture (3000 stimuli, 2 subjects × 2
     regions, 512 voxels) at full width: AlexNet, 14 taps, SRP k=4096,
     n_select 1000, 1000 bootstraps, Spearman, uint8 transfer, results.db.
     Checks results, db rows, finite scores, and that the kernel was
     launched exactly once per RDM the eval builds.
  5. kernels — the per-kernel summary line.

Then the card's name and power limit, and the final status line.
Needs CUDA; exits 1 without it.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import sqlite3
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published dense peaks and memory rate (NVIDIA data sheet).
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
MEM_BYTES_PER_S = 3.35e12
TOL = {"float32": 1e-5, "bfloat16": 3e-3}
SRP_TOL = 1e-5  # of the largest |value|: f32 summation order only
KERNEL_SHAPES = [  # (n, d, dtype): the eval's RDM shapes, and stage_rdm_pallas's
    (1000, 4096, "float32"), (1000, 4096, "bfloat16"), (1000, 193600, "float32"),
    (1000, 512, "float32"), (10000, 4096, "float32"), (10000, 4096, "bfloat16"),
    (257, 1031, "float32"), (257, 1031, "bfloat16"),  # ragged n and d: masked edges
]
E2E = {"n_shared": 1000, "n_unique": 1000, "n_subjects": 2, "n_regions": 2,
       "n_voxels": 512, "img_size": 256}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def phase_build():
    from visreps_tpu_torch.ops import rdm_kernel

    t0 = time.perf_counter()
    so = rdm_kernel.build()
    regs = [l.strip() for l in rdm_kernel.BUILD_LOG.splitlines() if "registers" in l]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": so.name, "ptxas": regs})


def phase_kernel():
    """Kernel vs plain version at each shape; returns per-shape records."""
    import torch

    from visreps_tpu_torch.ops import rdm_kernel

    gen = torch.Generator(device="cuda").manual_seed(0)
    records = []
    for n, d, dtype in KERNEL_SHAPES:
        x = torch.randn((n, d), device="cuda", generator=gen)
        x = x + 0.5 * torch.randn((1, d), device="cuda", generator=gen)  # correlated rows
        xc = x - x.mean(dim=1, keepdim=True)
        std = torch.sqrt((xc * xc).mean(dim=1) + 1e-12)
        xin = xc.to(getattr(torch, dtype)).contiguous()
        del x
        before = rdm_kernel.LAUNCHES
        out = rdm_kernel.rdm_from_centered(xin, std)
        torch.cuda.synchronize()
        if rdm_kernel.LAUNCHES != before + 1:
            raise RuntimeError("the kernel wrapper did not count its launch")
        ref = rdm_kernel.rdm_from_centered_reference(xin, std)
        err = (out - ref).abs().max().item()
        if not err <= TOL[dtype]:
            raise RuntimeError(f"rdm kernel disagrees at ({n}, {d}) {dtype}: "
                               f"max |err| {err} > {TOL[dtype]}")
        iters = max(2, min(50, int(2e11 // (2 * n * n * d)) + 1))
        ms = time_ms(lambda: rdm_kernel.rdm_from_centered(xin, std), iters)
        plain_ms = time_ms(lambda: rdm_kernel.rdm_from_centered_reference(xin, std), iters)
        library_ms = time_ms(lambda: torch.corrcoef(xin), iters)
        ops = float(n) * (n + 1) * d  # the symmetric product's upper triangle and diagonal
        nbytes = n * d * xin.element_size() + 4 * n + 4 * n * n
        t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / MEM_BYTES_PER_S
        rec = {"phase": "kernel", "name": "rdm", "n": n, "d": d, "dtype": dtype,
               "max_abs_err": err, "tol": TOL[dtype], "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": 1e3 * max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "tflops": ops / ms / 1e9}
        emit(rec)
        records.append(rec)
        del xin, xc, std, out, ref
        torch.cuda.empty_cache()
    return records


def phase_srp():
    """The SRP product on the card (one bf16 GEMM writing f32) against
    the CPU path's arithmetic on the same card (the bf16 operands widened
    to f32): they differ only in summation order. Shape: one extraction
    batch of conv1_pre taps, the largest projection (one chunk)."""
    import torch

    from visreps_tpu_torch.ops.srp import SRPTransform, apply_chunked

    d = 193600
    chunks = SRPTransform(k=4096, seed=0, device="cuda").matrix_chunks(d)
    x = torch.randn((256, d), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    got = apply_chunked(x, chunks)
    ref = torch.mm(x.to(torch.bfloat16).float(), torch.cat(chunks).float())
    err = ((got - ref).abs().max() / ref.abs().max()).item()
    emit({"phase": "srp", "d": d, "k": 4096, "chunks": len(chunks), "dtype": str(got.dtype),
          "max_rel_err": err, "tol": SRP_TOL})
    if got.dtype != torch.float32 or not err <= SRP_TOL:
        raise RuntimeError(f"SRP product disagrees with its f32 form: {err} > {SRP_TOL}")


def phase_e2e():
    """The eval end to end; returns the kernel's launch count in it."""
    tmp = Path(tempfile.mkdtemp(prefix="visreps_chip_smoke_"))
    try:
        return _e2e(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _e2e(tmp: Path) -> int:
    import torch

    os.environ.update({
        "VISREPS_BENCH_FIXTURE": str(tmp / "fixture"),
        "VISREPS_BENCH_N_SHARED": str(E2E["n_shared"]),
        "VISREPS_BENCH_N_UNIQUE": str(E2E["n_unique"]),
        "VISREPS_BENCH_N_SUBJECTS": str(E2E["n_subjects"]),
        "VISREPS_BENCH_N_REGIONS": str(E2E["n_regions"]),
        "VISREPS_BENCH_N_VOXELS": str(E2E["n_voxels"]),
        "VISREPS_BENCH_IMG_SIZE": str(E2E["img_size"]),
        "VISREPS_RESULTS_DB": str(tmp / "results.db"),
    })
    from visreps_tpu_torch.benchmarks import fixture

    t0 = time.perf_counter()
    meta = fixture.ensure_fixture()
    fixture_s = time.perf_counter() - t0
    os.environ["NSD_DATA_DIR"] = str(Path(meta["pickle"]).parent)
    os.environ["NSD_STIMULI_HDF5"] = meta["stimuli"]

    from visreps_tpu_torch import evals, run
    from visreps_tpu_torch.ops import rdm_kernel

    subjects = list(range(E2E["n_subjects"]))
    regions = ["early visual stream", "ventral visual stream"][: E2E["n_regions"]]
    overrides = [
        "load_model_from=torchvision", "model_name=AlexNet", "pretrained_dataset=none",
        "neural_dataset=nsd", "analysis=rsa", "compare_method=spearman",
        f"subject_idx={json.dumps(subjects)}", f"region={json.dumps(regions)}",
        "bootstrap=true", "n_bootstrap=1000", "n_select=1000", "srp_k=4096",
        "extract_pre_and_post=true", "uint8_transfer=true", "log_expdata=true",
        "batchsize=256", "num_workers=8",
    ]
    torch.cuda.synchronize()
    rdm_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    results = run.main(["--mode", "eval", "--config", str(ROOT / "configs/eval/base.json"),
                        "--override", *overrides])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rdm_kernel.LAUNCHES

    n_pairs = len(subjects) * len(regions)
    if len(results) != n_pairs:
        raise RuntimeError(f"{len(results)} results, expected {n_pairs}")
    with sqlite3.connect(os.environ["VISREPS_RESULTS_DB"]) as conn:
        db_rows = conn.execute("SELECT COUNT(*) FROM results").fetchone()[0]
    if db_rows != n_pairs:
        raise RuntimeError(f"{db_rows} results.db rows, expected {n_pairs}")
    for r in results:
        vals = [r["score"], r["ci_low"], r["ci_high"], *r["bootstrap_scores"]]
        if len(r["bootstrap_scores"]) != 1000 or not all(math.isfinite(v) for v in vals):
            raise RuntimeError(f"non-finite or missing scores in {r['layer']} result")
        if not -1.0 <= r["ci_low"] <= r["ci_high"] <= 1.0:
            raise RuntimeError(f"bad CI [{r['ci_low']}, {r['ci_high']}]")
    taps = [s["layer"] for s in results[0]["layer_selection_scores"]]
    n_layers = len(taps)
    unique_layers = len({r["layer"] for r in results})
    expected = len(subjects) * (n_layers + len(regions)) + unique_layers + n_pairs
    if launches != expected:
        raise RuntimeError(f"RDM kernel launched {launches} times in the eval, expected "
                           f"{expected} (= S·(taps + R) + unique layers + pairs)")
    phases = dict(evals.LAST_PHASE_TIMES)
    emit({"phase": "e2e", "seconds": wall, "fixture_s": fixture_s,
          "n_stimuli": meta["n_stimuli"], "n_results": len(results), "db_rows": db_rows,
          "taps": taps, "unique_layers": unique_layers,
          "rdm_launches": launches, "rdm_launches_expected": expected,
          "images_per_s": meta["n_stimuli"] / phases["extraction_s"],
          "phase_times_s": phases,
          "scores": [{"layer": r["layer"], "score": r["score"], "ci": [r["ci_low"], r["ci_high"]]}
                     for r in results],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    records = phase_kernel()
    phase_srp()
    launches = phase_e2e()

    main_shape = records[0]  # (1000, 4096) f32: phase-1 selection, most launches
    emit({"kernels": [{
        "name": "rdm", "route": "cuda", "source": "visreps_tpu_torch/csrc/rdm.cu",
        "replaces": "visreps_tpu/ops/rdm_pallas.py:29",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in records),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "shape": [main_shape["n"], main_shape["d"], main_shape["dtype"]],
    }]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
