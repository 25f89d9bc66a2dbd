#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero without the final line:

  1. build — compile the RDM kernel (csrc/rdm.cu) from this checkout and
     print ptxas's report of each kernel in it (Gram and reduce).
  2. kernel — the RDM kernel against its plain torch version on the card
     at the eval's shapes and one ragged shape (n and d not multiples of
     the tile) (f32 tolerance 1e-5, bf16 3e-3 against the plain version
     on the same bf16 rows); the output must be exactly symmetric, with
     an exactly zero diagonal, and bit-identical over two calls. With the
     kernel's time per call (CUDA events; beside it the host's time to
     enqueue the call, and the device time of the kernel's own launches
     from torch.profiler), the plain version's, one torch.corrcoef call's (the
     library yardstick), the card's lower bound for the work by the
     cheapest route that meets the type's tolerance (f32: three TF32
     tensor-core products; bf16: bf16 tensor cores), the bound without
     tensor cores (f32 FMA) beside it, and the launch plan (tiles, splits).
  3. srp — the SRP product on the card (bf16 GEMM, f32 out) against the
     same product in f32 on widened operands (relative tolerance 1e-5).
  4. e2e — the NSD RSA eval through ``python -m visreps_tpu_torch.run``'s
     entry point on a synthetic fixture (3000 stimuli, 2 subjects × 2
     regions, 512 voxels) at full width: AlexNet, 14 taps, SRP k=4096,
     n_select 1000, 1000 bootstraps, Spearman, uint8 transfer, results.db.
     Checks results, db rows, finite scores, and that the kernel was
     launched exactly once per RDM the eval builds.
  5. train — ``run.main(["--mode", "train", ...])`` with
     configs/train/base.json and PCA labels (CustomCNN at 224 px,
     pca_n_classes 32, AdamW, batch 256) on a synthetic on-disk ImageNet
     of 1600 JPEGs (1280 train images: 5 steps per epoch), two epochs.
     Checks finite losses and gradient norms, that the model and the
     batches were on the card, the checkpoint files, and that epoch 2's
     checkpoint loads back bit-identically; prints the loss per step,
     ms per step (CUDA events, steps 2–10), images/s, the seconds the
     step loop waited on the loader and peak device memory.
  6. train_step — the train step alone (CustomCNN, 1000 classes, batch
     256 on the card, AdamW): ms per step over 8 steps after a warm-up,
     images/s, peak memory, and its bound (3 × the forward's operations
     over the f32 FMA peak). Holds one step at batch 8 without dropout on
     the card against the same step on the CPU (loss and gradient norm
     within rtol 1e-4, BN running statistics within 1e-4 of each
     tensor's largest value).
  7. e2e_ckpt — the e2e eval again, of the checkpoint the train phase
     wrote (``load_model_from=checkpoint``, cfg_id 32, epoch 2), with the
     same checks; its rows must carry cfg_id 32 and epoch 2.
  8. path — the RDM shapes both evals called, with their launch counts
     and the kernel's time at each: its time on the main path, Σ launches
     × ms. A shape the kernel phase did not check gets the kernel phase's
     checks here before it is timed.
  9. kernels — the per-kernel summary line (launches: both evals).

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
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published dense peaks and memory rate (NVIDIA data sheet).
# The bound takes the cheapest route that meets the type's tolerance:
# f32 as three TF32 products (3xTF32), bf16 on the bf16 tensor cores.
# The bound of f32 on the FMA units, without tensor cores, stays beside it.
BOUND_ROUTE = {"float32": ("3xTF32 tensor cores", 3, 495e12),
               "bfloat16": ("bf16 tensor cores", 1, 989e12)}
FMA_PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
MEM_BYTES_PER_S = 3.35e12
TOL = {"float32": 1e-5, "bfloat16": 3e-3}
SRP_TOL = 1e-5  # of the largest |value|: f32 summation order only
KERNEL_SHAPES = [  # (n, d, dtype): the eval's RDM shapes, and stage_rdm_pallas's
    (1000, 4096, "float32"), (1000, 4096, "bfloat16"), (1000, 193600, "float32"),
    (1000, 290400, "float32"), (1000, 186624, "float32"),  # CustomCNN conv1_pre, conv2_pre
    (1000, 512, "float32"),
    (10000, 4096, "float32"), (10000, 4096, "bfloat16"),
    (257, 1031, "float32"), (257, 1031, "bfloat16"),  # ragged n and d: padded stride
]
E2E = {"n_shared": 1000, "n_unique": 1000, "n_subjects": 2, "n_regions": 2,
       "n_voxels": 512, "img_size": 256}
TRAIN = {"n_images": 1600, "batch": 256, "epochs": 2, "pca_n_classes": 32}
STEP = {"batch": 256, "iters": 8, "classes": 1000, "parity_batch": 8}
STEP_RTOL = 1e-4  # card vs CPU: cuDNN and the CPU sum in different orders


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int) -> tuple[float, float]:
    """Device ms per call (CUDA events around ``iters`` calls after a
    warm-up call) and the host's ms per call to enqueue them (where that
    is not below the device's, the host sets the pace)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0) / iters
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters, host_ms


def timing_iters(n: int, d: int) -> int:
    return max(2, min(50, int(2e11 // (2 * n * n * d)) + 1))


def time_kernel(xin, std) -> tuple[float, float]:
    """The kernel's device and host-enqueue ms per call at these rows."""
    from visreps_tpu_torch.ops import rdm_kernel

    n, d = xin.shape
    return time_ms(lambda: rdm_kernel.rdm_from_centered(xin, std), timing_iters(n, d))


def profile_kernel(xin, std) -> dict:
    """Device ms per call of the RDM's own CUDA kernels (Gram, and the
    reduce where d is split), from torch.profiler: the kernel without the
    wrapper's host work. None where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from visreps_tpu_torch.ops import rdm_kernel

    iters = timing_iters(*xin.shape)
    rdm_kernel.rdm_from_centered(xin, std)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            rdm_kernel.rdm_from_centered(xin, std)
        torch.cuda.synchronize()
    us = {"gram": 0.0, "reduce": 0.0}
    for e in prof.events():  # each launch (key_averages() was seen to drop one)
        for name in us:
            if f"rdm_{name}_kernel" in e.name:
                us[name] += e.device_time_total
    total = us["gram"] + us["reduce"]
    return {"device_ms": total / iters / 1e3 if total > 0 else None,
            "reduce_ms": us["reduce"] / iters / 1e3 if total > 0 else None}


def bound(n: int, d: int, dtype: str) -> dict:
    """The least time the card could take: the n(n+1)·d operations of
    the symmetric product's upper triangle and diagonal over the peak of
    the cheapest route for the type, or the bytes (rows in, RDM out) over
    the memory rate, whichever is larger; and the f32-FMA bound."""
    route, passes, peak = BOUND_ROUTE[dtype]
    ops = float(n) * (n + 1) * d
    nbytes = n * d * (4 if dtype == "float32" else 2) + 4 * n + 4 * n * n
    t_ops, t_bytes = passes * ops / peak, nbytes / MEM_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_route": route,
            "bound_ms_fma": 1e3 * max(ops / FMA_PEAK_OPS[dtype], t_bytes)}


def random_rows(n: int, d: int, dtype: str, gen):
    """Correlated centred rows in ``dtype`` and their f32 stds."""
    import torch

    x = torch.randn((n, d), device="cuda", generator=gen)
    x = x + 0.5 * torch.randn((1, d), device="cuda", generator=gen)
    xc = x - x.mean(dim=1, keepdim=True)
    std = torch.sqrt((xc * xc).mean(dim=1) + 1e-12)
    return xc.to(getattr(torch, dtype)).contiguous(), std


def phase_build():
    from visreps_tpu_torch.ops import rdm_kernel

    t0 = time.perf_counter()
    so = rdm_kernel.build()
    seconds = time.perf_counter() - t0
    kernels, warnings = [], []
    for line in rdm_kernel.BUILD_LOG.splitlines():
        if "Compiling entry function" in line:
            kernels.append({"function": line.split("'")[1], "ptxas": []})
        elif kernels and any(k in line for k in ("registers", "spill", "stack frame")):
            kernels[-1]["ptxas"].append(line.strip())
        elif "warning" in line.lower():
            warnings.append(line.strip())
    emit({"phase": "build", "seconds": seconds, "library": so.name, "kernels": kernels,
          "warnings": warnings})


def check_kernel(xin, std) -> float:
    """Two kernel calls on these rows: each must count one launch, the
    output must be exactly symmetric with an exactly zero diagonal, the
    two outputs bit-identical, and within TOL of the plain version.
    Returns the max |err|."""
    import torch

    from visreps_tpu_torch.ops import rdm_kernel

    (n, d), dtype = xin.shape, str(xin.dtype).removeprefix("torch.")
    before = rdm_kernel.LAUNCHES
    out = rdm_kernel.rdm_from_centered(xin, std)
    again = rdm_kernel.rdm_from_centered(xin, std)
    torch.cuda.synchronize()
    if rdm_kernel.LAUNCHES != before + 2:
        raise RuntimeError("the kernel wrapper did not count its launches")
    if not torch.equal(out, out.T):
        raise RuntimeError(f"rdm kernel output not exactly symmetric at ({n}, {d}) {dtype}")
    if not bool((out.diagonal() == 0).all()):
        raise RuntimeError(f"rdm kernel diagonal not exactly 0 at ({n}, {d}) {dtype}")
    if not torch.equal(out, again):
        raise RuntimeError(f"rdm kernel not bit-reproducible at ({n}, {d}) {dtype}")
    err = (out - rdm_kernel.rdm_from_centered_reference(xin, std)).abs().max().item()
    if not err <= TOL[dtype]:
        raise RuntimeError(f"rdm kernel disagrees at ({n}, {d}) {dtype}: "
                           f"max |err| {err} > {TOL[dtype]}")
    return err


def launch_plan(xin) -> dict:
    """The wrapper's plan for these rows on this card."""
    from visreps_tpu_torch.ops import rdm_kernel

    plan = rdm_kernel.plan(*xin.shape, xin.element_size(),
                           rdm_kernel.device_sms(xin.device.index))
    return {"tiles": plan.tiles, "splits": plan.splits, "sms": plan.sms}


def phase_kernel():
    """Kernel vs plain version at each shape; returns per-shape records."""
    import torch

    from visreps_tpu_torch.ops import rdm_kernel

    gen = torch.Generator(device="cuda").manual_seed(0)
    records = []
    for n, d, dtype in KERNEL_SHAPES:
        xin, std = random_rows(n, d, dtype, gen)
        err = check_kernel(xin, std)
        ms, host_ms = time_kernel(xin, std)
        device = profile_kernel(xin, std)
        iters = timing_iters(n, d)
        plain_ms = time_ms(lambda: rdm_kernel.rdm_from_centered_reference(xin, std), iters)[0]
        library_ms = time_ms(lambda: torch.corrcoef(xin), iters)[0]
        rec = {"phase": "kernel", "name": "rdm", "n": n, "d": d, "dtype": dtype,
               "max_abs_err": err, "tol": TOL[dtype], "ms": ms, "host_ms": host_ms, **device,
               "plain_ms": plain_ms, "library_ms": library_ms, **bound(n, d, dtype),
               **launch_plan(xin), "tflops": float(n) * (n + 1) * d / ms / 1e9}
        emit(rec)
        records.append(rec)
        del xin, std
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


def nsd_fixture(tmp: Path) -> dict:
    """The e2e evals' synthetic NSD fixture and results.db under ``tmp``."""
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
    meta["fixture_s"] = time.perf_counter() - t0
    os.environ["NSD_DATA_DIR"] = str(Path(meta["pickle"]).parent)
    os.environ["NSD_STIMULI_HDF5"] = meta["stimuli"]
    return meta


def run_eval(phase: str, meta: dict, source: list[str], db_where: str, expect_row):
    """The eval through ``run.main`` on the fixture, with the kernel's
    launch count set to 0 just before and read just after; checks
    results, db rows (``db_where`` selects this eval's; ``expect_row``
    checks each row's (cfg_id, epoch)), finite scores and one launch per
    RDM. Returns the launches and the count of RDMs at each (n, d, dtype)."""
    import torch

    from visreps_tpu_torch import evals, run
    from visreps_tpu_torch.ops import rdm as rdm_ops
    from visreps_tpu_torch.ops import rdm_kernel

    shapes = Counter()  # the RDM shapes compute_rdm hands the kernel wrapper
    wrapper = rdm_ops.rdm_from_centered

    def probe(xc, std, correction=1e-12):
        shapes[(xc.shape[0], xc.shape[1], str(xc.dtype).removeprefix("torch."))] += 1
        return wrapper(xc, std, correction)

    subjects = list(range(E2E["n_subjects"]))
    regions = ["early visual stream", "ventral visual stream"][: E2E["n_regions"]]
    overrides = [
        *source, "neural_dataset=nsd", "analysis=rsa", "compare_method=spearman",
        f"subject_idx={json.dumps(subjects)}", f"region={json.dumps(regions)}",
        "bootstrap=true", "n_bootstrap=1000", "n_select=1000", "srp_k=4096",
        "extract_pre_and_post=true", "uint8_transfer=true", "log_expdata=true",
        "batchsize=256", "num_workers=8",
    ]
    torch.cuda.synchronize()
    rdm_ops.rdm_from_centered = probe
    try:
        rdm_kernel.LAUNCHES = 0
        t0 = time.perf_counter()
        results = run.main(["--mode", "eval", "--config", str(ROOT / "configs/eval/base.json"),
                            "--override", *overrides])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = rdm_kernel.LAUNCHES
    finally:
        rdm_ops.rdm_from_centered = wrapper

    n_pairs = len(subjects) * len(regions)
    if len(results) != n_pairs:
        raise RuntimeError(f"{len(results)} results, expected {n_pairs}")
    with sqlite3.connect(os.environ["VISREPS_RESULTS_DB"]) as conn:
        rows = conn.execute(f"SELECT cfg_id, epoch FROM results WHERE {db_where}").fetchall()
    if len(rows) != n_pairs or not all(expect_row(*r) for r in rows):
        raise RuntimeError(f"results.db rows {rows}, expected {n_pairs} of this eval")
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
    if launches != expected or sum(shapes.values()) != expected:
        raise RuntimeError(f"RDM kernel launched {launches} times in the eval for "
                           f"{sum(shapes.values())} RDMs, expected {expected} "
                           f"(= S·(taps + R) + unique layers + pairs)")
    phases = dict(evals.LAST_PHASE_TIMES)
    emit({"phase": phase, "seconds": wall, "fixture_s": meta["fixture_s"],
          "n_stimuli": meta["n_stimuli"], "n_results": len(results), "db_rows": rows,
          "taps": taps, "unique_layers": unique_layers,
          "rdm_launches": launches, "rdm_launches_expected": expected,
          "rdm_shapes": [[*k, v] for k, v in sorted(shapes.items())],
          "images_per_s": meta["n_stimuli"] / phases["extraction_s"],
          "phase_times_s": phases,
          "scores": [{"layer": r["layer"], "score": r["score"], "ci": [r["ci_low"], r["ci_high"]]}
                     for r in results],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches, shapes


def phase_e2e(meta: dict):
    """The untrained AlexNet eval (the first slice's main path)."""
    return run_eval("e2e", meta, ["load_model_from=torchvision", "model_name=AlexNet",
                                  "pretrained_dataset=none"],
                    "cfg_id = 'untrained'", lambda cfg_id, epoch: epoch == -1)


def phase_e2e_ckpt(meta: dict, checkpoint_dir: str):
    """The eval of the checkpoint the train phase wrote (epoch 2)."""
    return run_eval("e2e_ckpt", meta, [
        "load_model_from=checkpoint", f"cfg_id={TRAIN['pca_n_classes']}",
        f"checkpoint_dir={checkpoint_dir}",
        f"checkpoint_model=checkpoint_epoch_{TRAIN['epochs']}.pth"],
        f"cfg_id = {TRAIN['pca_n_classes']}",
        lambda cfg_id, epoch: cfg_id == TRAIN["pca_n_classes"] and epoch == TRAIN["epochs"])


def custom_cnn_forward_flops(num_classes: int, size: int = 224) -> float:
    """2 × the multiply-adds of one CustomCNN forward on one image, from
    its conv specs (convolutions and dense layers; BatchNorm, pooling and
    ReLU are not counted)."""
    from visreps_tpu_torch.models.custom_cnn import CustomCNN

    macs, ch, hw = 0, 3, size
    for out, k, stride, pad, pool in CustomCNN.CONV_SPECS:
        hw = (hw + 2 * pad - k) // stride + 1
        macs += hw * hw * out * k * k * ch
        ch = out
        if pool:
            hw = (hw - CustomCNN.POOL) // 2 + 1
    feats = ch * CustomCNN.GRID * CustomCNN.GRID
    for out in (CustomCNN.FC, CustomCNN.FC, num_classes):
        macs += feats * out
        feats = out
    return 2.0 * macs


def phase_train(tmp: Path) -> str:
    """Train CustomCNN on PCA labels through the CLI's entry point; returns
    the checkpoint directory the eval reads (``{dir}`` of ``{dir}/cfg32a``)."""
    import torch

    from visreps_tpu_torch import run
    from visreps_tpu_torch.benchmarks.fixture import write_imagenet_fixture
    from visreps_tpu_torch.models.convert import params_from_jax
    from visreps_tpu_torch.train import checkpoint as ckpt
    from visreps_tpu_torch.train import trainer as trainer_mod

    t0 = time.perf_counter()
    data = write_imagenet_fixture(tmp / "imagenet", TRAIN["n_images"],
                                  pca_n_classes=TRAIN["pca_n_classes"])
    fixture_s = time.perf_counter() - t0
    checkpoint_dir = str(tmp / "model_checkpoints")
    steps = []  # per step: (start event, stop event, batch device, params devices)
    step_fn = trainer_mod.train_step

    def probe(model, optimizer, images, labels, *args, **kwargs):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = step_fn(model, optimizer, images, labels, *args, **kwargs)
        stop.record()
        steps.append((start, stop, {images.device.type, labels.device.type},
                      {p.device.type for p in model.parameters()}))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer_mod.train_step = probe
    try:
        t0 = time.perf_counter()
        trainer = run.main([
            "--mode", "train", "--config", str(ROOT / "configs/train/base.json"), "--override",
            "pca_labels=true", f"pca_n_classes={TRAIN['pca_n_classes']}",
            f"batchsize={TRAIN['batch']}", f"num_epochs={TRAIN['epochs']}",
            "warmup_epochs=1",  # base.json's 2 would leave the cosine no epochs
            "num_workers=16", "log_interval=1", "checkpoint_interval=1",
            "log_checkpoints=true", f"checkpoint_dir={checkpoint_dir}",
            *(f"{k}={v}" for k, v in data.items())])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        trainer_mod.train_step = step_fn

    n_steps = TRAIN["epochs"] * (int(TRAIN["n_images"] * 0.8) // TRAIN["batch"])
    history = trainer.history
    if len(history) != n_steps or len(steps) != n_steps:
        raise RuntimeError(f"{len(history)} train steps, expected {n_steps}")
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in history):
        raise RuntimeError(f"non-finite loss or gradient norm: {history}")
    if not all(batch == {"cuda"} and params == {"cuda"} for _, _, batch, params in steps):
        raise RuntimeError("a train step ran with the batch or the model off the card")
    run_dir = Path(checkpoint_dir) / f"cfg{TRAIN['pca_n_classes']}a"
    expected = [f"checkpoint_epoch_{e}.pth" for e in range(TRAIN["epochs"] + 1)]
    missing = [f for f in (*expected, "config.json", "training_metrics.csv")
               if not (run_dir / f).is_file()]
    if missing:
        raise RuntimeError(f"train phase did not write {missing} in {run_dir}")
    loaded, payload = ckpt.load_checkpoint(run_dir / expected[-1], device="cuda")
    trained = trainer.model.state_dict()
    reloaded = params_from_jax(payload["params"], payload["batch_stats"])
    same = set(reloaded) == set(trained) and all(
        torch.equal(loaded.state_dict()[k], trained[k]) for k in trained
        if not k.endswith("num_batches_tracked"))
    if not same or payload["epoch"] != TRAIN["epochs"]:
        raise RuntimeError("epoch 2's checkpoint does not load back bit-identically")
    step_ms = [a.elapsed_time(b) for a, b, _, _ in steps]
    timed = step_ms[1:]  # steps 2–10
    ms = sum(timed) / len(timed)
    emit({"phase": "train", "seconds": wall, "fixture_s": fixture_s,
          "n_train": len(trainer.datasets["train"]), "n_test": len(trainer.datasets["test"]),
          "steps": len(history), "loss": [h["loss"] for h in history],
          "grad_norm": [h["grad_norm"] for h in history],
          "step_ms": step_ms, "ms_per_step": ms, "images_per_s": TRAIN["batch"] / ms * 1e3,
          "loader_wait_s": trainer.loader_wait_s,
          "metrics_csv": (run_dir / "training_metrics.csv").read_text().splitlines(),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return checkpoint_dir


def _step_cfg():
    from visreps_tpu_torch.core.config import Config

    return Config({"optimizer": "adamw", "learning_rate": 0.002, "weight_decay": 0.001,
                   "grad_clip": 1.0, "lr_scheduler": "cosineannealinglr", "num_epochs": 20,
                   "warmup_epochs": 2})


def phase_train_step():
    """The train step alone at batch 256 (the JAX bench's stage_train),
    and one step on the card against the same step on the CPU."""
    import torch

    from visreps_tpu_torch.models.zoo import init_model
    from visreps_tpu_torch.train.optim import Optimizer
    from visreps_tpu_torch.train.trainer import train_step

    cfg = _step_cfg()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = init_model("CustomCNN", STEP["classes"], seed=0, device="cuda")
    opt = Optimizer(model, cfg, 100, model.trainable_mask())
    images = torch.randn((STEP["batch"], 3, 224, 224), device="cuda", generator=gen)
    labels = torch.arange(STEP["batch"], device="cuda") % STEP["classes"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train_step(model, opt, images, labels, gen, 0)  # warm-up
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(STEP["iters"]):
        loss, grad_norm = train_step(model, opt, images, labels, gen, 1 + i)
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / STEP["iters"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not (math.isfinite(loss.item()) and math.isfinite(grad_norm.item())):
        raise RuntimeError("non-finite loss or gradient norm in the timed steps")
    flops = custom_cnn_forward_flops(STEP["classes"])
    ops_ms = 1e3 * 3 * flops * STEP["batch"] / FMA_PEAK_OPS["float32"]
    del model, opt, images, labels
    torch.cuda.empty_cache()

    # One step at batch 8 without dropout, card against CPU, same weights and batch.
    b = STEP["parity_batch"]
    x = torch.randn((b, 3, 224, 224), generator=torch.Generator().manual_seed(1))
    y = torch.arange(b) % STEP["classes"]
    out = {}
    for dev in ("cpu", "cuda"):
        m = init_model("CustomCNN", STEP["classes"], seed=0, device=dev, arch={"dropout": 0.0})
        o = Optimizer(m, cfg, 100, m.trainable_mask())
        lo, gn = train_step(m, o, x.to(dev), y.to(dev), None, 0)
        out[dev] = (lo.item(), gn.item(),
                    {k: v.cpu() for k, v in m.state_dict().items() if "running_" in k})
    (l_cpu, g_cpu, s_cpu), (l_gpu, g_gpu, s_gpu) = out["cpu"], out["cuda"]
    stat_err = max(((s_gpu[k] - s_cpu[k]).abs().max() / s_cpu[k].abs().max()).item()
                   for k in s_cpu)
    rec = {"phase": "train_step", "batch": STEP["batch"], "classes": STEP["classes"],
           "ms_per_step": ms, "images_per_s": STEP["batch"] / ms * 1e3, "peak_mem_gb": peak,
           "forward_gflop_per_image": flops / 1e9,
           "bound_ms": ops_ms, "bound_by": "operations", "bound_peak": "f32 FMA 67 TFLOP/s",
           "parity": {"batch": b, "loss": [l_cpu, l_gpu], "grad_norm": [g_cpu, g_gpu],
                      "bn_stats_max_rel_err": stat_err, "rtol": STEP_RTOL}}
    emit(rec)
    if not (abs(l_gpu - l_cpu) <= STEP_RTOL * abs(l_cpu)
            and abs(g_gpu - g_cpu) <= STEP_RTOL * abs(g_cpu) and stat_err <= STEP_RTOL):
        raise RuntimeError(f"train step on the card disagrees with the CPU: {rec['parity']}")


def phase_path(shapes: Counter, records: list) -> float:
    """The kernel's time on the main path: at each RDM shape the eval
    asked for, its launches there times its ms per call. A shape the
    kernel phase did not check is checked here as there (``check_kernel``)
    and timed; its max |err| joins ``records``' in the summary line."""
    import torch

    seen = {(r["n"], r["d"], r["dtype"]): r for r in records}
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for (n, d, dtype), count in sorted(shapes.items()):
        rec = seen.get((n, d, dtype))
        if rec is None:
            xin, std = random_rows(n, d, dtype, gen)
            rec = {"n": n, "d": d, "dtype": dtype, "max_abs_err": check_kernel(xin, std),
                   "tol": TOL[dtype], "ms": time_kernel(xin, std)[0], **launch_plan(xin)}
            del xin, std
            torch.cuda.empty_cache()
        rows.append({"n": n, "d": d, "dtype": dtype, "launches": count,
                     "checked_here": (n, d, dtype) not in seen,
                     **{k: rec[k] for k in ("ms", "max_abs_err", "tol", "tiles", "splits")},
                     **bound(n, d, dtype)})
    total = sum(r["launches"] * r["ms"] for r in rows)
    emit({"phase": "path", "shapes": rows, "kernel_ms_on_path": total,
          "bound_ms_on_path": sum(r["launches"] * r["bound_ms"] for r in rows)})
    records.extend(r for r in rows if r["checked_here"])
    return total


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
    tmp = Path(tempfile.mkdtemp(prefix="visreps_chip_smoke_"))
    try:
        meta = nsd_fixture(tmp)
        launches, shapes = phase_e2e(meta)
        checkpoint_dir = phase_train(tmp)
        phase_train_step()
        ckpt_launches, ckpt_shapes = phase_e2e_ckpt(meta, checkpoint_dir)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches += ckpt_launches
    phase_path(shapes + ckpt_shapes, records)

    main_shape = records[0]  # (1000, 4096) f32: phase-1 selection, most launches
    emit({"kernels": [{
        "name": "rdm", "route": "cuda", "source": "visreps_tpu_torch/csrc/rdm.cu",
        "replaces": "visreps_tpu/ops/rdm_pallas.py:29",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in records),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
        "bound_route": main_shape["bound_route"],
        "library_ms": main_shape["library_ms"],
        "tiles": main_shape["tiles"], "splits": main_shape["splits"],
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
