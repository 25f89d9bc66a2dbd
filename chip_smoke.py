#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero without the final line:

  1. build — compile the RDM kernel (csrc/rdm.cu) from this checkout and
     print ptxas's report of each kernel in it (Gram and reduce).
  2. kernel — the RDM kernel against its plain torch version on the card
     at the eval's shapes, one ragged shape (n and d not multiples of
     the tile), n = 100, below one 128-row tile (TVSD's test set), and
     THINGS' widest evaluation RDM, (1,484, 193,600), and the phase-2
     widths of ResNet50, ViT-B/16 and VGG16 at n = 1,000, up to VGG16's
     conv1 (d = 3,211,264: a 12.8 GB f32 input, n·d above 2³¹)
     (f32 tolerance 1e-5 up to d = 290,400, then growing as √d with the
     f32 rounding error of a d-term sum, 3.3e-5 at 3,211,264, where both
     versions' errors against an f64 Gram are printed too; bf16 3e-3
     against the plain version on the same bf16 rows); the output must
     be exactly symmetric, with an
     exactly zero diagonal, and bit-identical over two calls. With the
     kernel's time per call (CUDA events; beside it the host's time to
     enqueue the call, and the device time of the kernel's own launches
     from torch.profiler), the plain version's, one torch.corrcoef call's (the
     library yardstick), the card's lower bound for the work by the
     cheapest route that meets the type's tolerance (f32: three TF32
     tensor-core products; bf16: bf16 tensor cores), the bound without
     tensor cores (f32 FMA) beside it, and the launch plan (tiles, splits).
  3. srp — the SRP product on the card (bf16 GEMM, f32 out) against the
     same product in f32 on widened operands (relative tolerance 1e-5).
  4. models — ResNet18, ResNet50, VGG16, ViT-B/16 and ECTiedNet at full
     width from seeded weights (init_model, seed 0, 1000 classes): the
     parameter count equal to the JAX model's, and a forward of 2 images
     on the card against the same forward on the CPU, every tap within
     1e-4 of the tap's largest |value| (TF32 off); with the card's ms per
     image of an all-taps forward at the eval's batch.
  5. e2e — the NSD RSA eval through ``python -m visreps_tpu_torch.run``'s
     entry point on a synthetic fixture (3000 stimuli, 2 subjects × 2
     regions, 512 voxels) at full width: AlexNet, 14 taps, SRP k=4096,
     n_select 1000, 1000 bootstraps, Spearman, uint8 transfer, results.db.
     Checks results, db rows, finite scores, and that the kernel was
     launched exactly once per RDM the eval builds.
  6. train — ``run.main(["--mode", "train", ...])`` with
     configs/train/base.json and PCA labels (CustomCNN at 224 px,
     pca_n_classes 32, AdamW, batch 256) on a synthetic on-disk ImageNet
     of 1600 JPEGs (1280 train images: 5 steps per epoch), two epochs.
     Checks finite losses and gradient norms, that the model and the
     batches were on the card, the checkpoint files, and that epoch 2's
     checkpoint loads back bit-identically; prints the loss per step,
     ms per step (CUDA events, steps 2–10), images/s, the seconds the
     step loop waited on the loader and peak device memory.
  7. train_step — the train step alone (CustomCNN, 1000 classes, batch
     256 on the card, AdamW): ms per step over 8 steps after a warm-up,
     images/s, peak memory, and its bound (3 × the forward's operations
     over the f32 FMA peak). Holds one step at batch 8 without dropout on
     the card against the same step on the CPU (loss and gradient norm
     within rtol 1e-4, BN running statistics within 1e-4 of each
     tensor's largest value).
  8. e2e_ckpt — the e2e eval again, of the checkpoint the train phase
     wrote (``load_model_from=checkpoint``, cfg_id 32, epoch 2), with the
     same checks; its rows must carry cfg_id 32 and epoch 2.
  9. things — the THINGS eval (the JAX bench's stage_things_e2e:
     untrained AlexNet, 14 taps, SRP k=4096, Spearman, 1000 bootstraps,
     uint8 transfer, results.db) on a fixture of 1,854 concepts × 14
     images (25,956 ids over a pool of 4,096 distinct 256 px JPEGs) and
     66-d embeddings. Checks one result and one results.db row with
     region and subject "N/A", 14 selection scores, finite scores and
     1000 bootstrap scores, 370 selection / 1,484 evaluation concepts,
     the store, the concept means and the selected layer's re-extracted
     means on the card, and 14 + 1 + 2 RDM launches.
 10. tvsd — the TVSD eval (stage_tvsd_e2e: n_select 1000, the same
     width) on 22,248 train + 100 test JPEG ids (the same pool) × 2
     monkeys × V1/V4/IT × 256 sites. Checks 6 results and rows and
     S·(14 + R) + U + P = 40 + U launches.
 11. nsd_synthetic — the NSD-Synthetic eval (stage_nsd_synthetic_e2e)
     on 220 PNG stimuli × 8 subjects × 6 regions × 512 voxels, over the
     results.db the e2e phase wrote: its 4 pairs inherit e2e's selected
     layers (the chain users run, NSD first), the other 44 are seeded
     with conv5_post. Checks 48 results and rows, the 4 inherited layers,
     and U + 48 launches.
 12. ref_ckpt — a CustomCNN checkpoint in the reference's own format (a
     torch zip file holding the whole pickled module, 64 classes, epoch
     20) through ``train.checkpoint.load_checkpoint`` on the card and on
     the CPU: its config, and logits within 1e-4 of the largest against
     each other and against the pickled module's own forward; then the
     e2e eval of it (``load_model_from=checkpoint``, cfg_id 64, epoch 20).
 13. e2e_resnet50, e2e_vit, e2e_vgg16 — the e2e eval of ResNet50,
     ViT-B/16 and VGG16 with ``pretrained_dataset=imagenet1k``: a seeded
     state dict in torchvision's layout, written under torchvision's file
     name into a temporary TORCH_WEIGHTS_DIR, is imported (the loaded
     model's first layer, a middle one and its head must equal the
     file's: no random-init fallback). 18, 14 and 30 selection taps;
     VGG16 at batch 128 (its 30 f32 taps at 256 would not fit beside its
     50 GB of SRP matrices). Rows carry cfg_id 'pretrained' and epoch −1.
     Each also prints the SRP matrices' size, the tap floats per image,
     the peak memory of extraction and of phase 2 with the exact layers'
     widths and bytes.
     Each eval phase prints its wall and phase times, extraction images/s
     with the loader's wait, peak device memory, fixture seconds and the
     RDM shapes it asked for; the checks of e2e hold for each (results,
     rows, finite scores, S·(T + R) + U + P launches for T taps).
 14. path — the RDM shapes every RSA eval called, with their launch
     counts and the kernel's time at each: its time on the main path, Σ
     launches × ms. A shape the kernel phase did not check gets the
     kernel phase's checks here before it is timed, beside the plain
     version's and torch.corrcoef's times.
 15. encoding — the NSD encoding-score eval through ``run.main`` at full
     width (untrained AlexNet, 14 taps, SRP k=4096, uint8 transfer,
     ``encoding_cv_precision=high``, 1000 bootstraps, results.db) on a
     synthetic fixture at NSD's own counts, built in its own directory:
     1,000 shared + 2 × 9,000 unique stimuli (19,000), 2 subjects × 2
     regions × 7,604 voxels. 7,200 fit rows keep the Woodbury route.
     Checks 4 results and 4 results.db rows, 14 selection scores each,
     finite scores, CIs and 1000 bootstrap scores, -1 ≤ ci_low ≤ ci_high
     ≤ 1, the store and every ridge tensor on the card, the route (no
     per-fold eigh), and no RDM launch. Prints the eval's and the
     encoding module's phase times, extraction images/s, ms per 4096
     eigh (alone and in a batch of 14), 20 small inverses one by one
     and batched, peak memory, and the operation counts of the
     selection sweep and the refits with their bounds.
 16. encoding_check — one subject's ``compute_encoding_scores_subject``
     on planted data (y = tap3·W + noise; 3 taps, 2 regions × 1,000
     voxels, 1,000 test rows) on both solver routes: n_train 6,400 and
     d 512 (Woodbury), n_train 400 and d 512 (per-fold eigh, on the
     alphas ≥ 1, where its rank-deficient fold Grams do not decide the
     result by roundoff; the protocol's 20 alphas are run too and their
     card-vs-CPU difference printed). At ``highest`` the card and the CPU
     select the same layers and agree within 1e-4 (scores and CIs); on
     the card ``high`` selects the layers ``highest`` does, with
     |Δscore| ≤ 1e-3.
 17. kernels — the per-kernel summary line (launches: the nine RSA
     evals; the encoding eval launches none).

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
TOL_WIDTH = 290_400  # the widest f32 rows TOL was set at (CustomCNN conv1); see tolerance()
SRP_TOL = 1e-5  # of the largest |value|: f32 summation order only
KERNEL_SHAPES = [  # (n, d, dtype): the eval's RDM shapes, and stage_rdm_pallas's
    (1000, 4096, "float32"), (1000, 4096, "bfloat16"), (1000, 193600, "float32"),
    (1000, 290400, "float32"), (1000, 186624, "float32"),  # CustomCNN conv1_pre, conv2_pre
    (1000, 512, "float32"),
    (10000, 4096, "float32"), (10000, 4096, "bfloat16"),
    (257, 1031, "float32"), (257, 1031, "bfloat16"),  # ragged n and d: padded stride
    (100, 4096, "float32"), (100, 4096, "bfloat16"),  # n below one 128-row tile (TVSD test)
    (100, 1031, "float32"),                           # ... and ragged d
    (1484, 193600, "float32"),  # THINGS evaluation when conv1 is selected
    # phase-2 exact taps of the pretrained evals (n = 1,000 shared stimuli)
    (1000, 3211264, "float32"), (1000, 1605632, "float32"),  # VGG16 conv1-2, conv3-4
    (1000, 802816, "float32"),   # ResNet50 conv1, block1-3; VGG16 conv5-7
    (1000, 401408, "float32"),   # ResNet50 block4-7; VGG16 conv8-10
    (1000, 200704, "float32"),   # ResNet50 block8-13
    (1000, 100352, "float32"),   # ResNet50 block14-16; VGG16 conv11-13
    (1000, 151296, "float32"), (1000, 150528, "float32"),  # ViT-B block1-12, patch_embed
    (1000, 1000, "float32"),     # ResNet50 fc1, ViT-B head (k = D = 1000)
]
E2E = {"n_shared": 1000, "n_unique": 1000, "n_subjects": 2, "n_regions": 2,
       "n_voxels": 512, "img_size": 256}
THINGS = {"n_concepts": 1854, "imgs_per_concept": 14, "n_jpeg": 4096,
          "img_size": 256}  # stage_things_e2e: 25,956 images, 66-d embeddings
TVSD = {"n_concepts": 1854, "imgs_per_concept": 12, "n_test": 100, "n_sites": 256,
        "n_jpeg": 4096, "img_size": 256}  # stage_tvsd_e2e: 22,248 train + 100 test images
NSD_SYNTHETIC = {"n_stimuli": 220, "n_subjects": 8, "n_regions": 6, "n_voxels": 512,
                 "img_size": 256}  # stage_nsd_synthetic_e2e
NSD_REGIONS = ["early visual stream", "ventral visual stream", "V1", "V2", "V3", "hV4"]
ENCODING = {"n_shared": 1000, "n_unique": 9000, "n_subjects": 2, "n_regions": 2,
            "n_voxels": 7604, "img_size": 256}  # 7,604: the widest NSD ROI of the JAX bench
ENC_CHECK = {"routes": {"woodbury": (6400, 512), "eigh": (400, 512)},
             "taps": 3, "voxels": 1000, "n_test": 1000, "n_bootstrap": 1000}
ENC_TOL = 1e-4       # card vs CPU at "highest": scores and CIs
ENC_HIGH_TOL = 1e-3  # "high" vs "highest" on the card: |Δscore|
TF32_PEAK_OPS = 495e12
TRAIN = {"n_images": 1600, "batch": 256, "epochs": 2, "pca_n_classes": 32}
STEP = {"batch": 256, "iters": 8, "classes": 1000, "parity_batch": 8}
STEP_RTOL = 1e-4  # card vs CPU: cuDNN and the CPU sum in different orders
# Parameters of the JAX package's models at 1000 classes (jax.eval_shape of
# visreps_tpu/models; tests/test_torch_port_models.py holds these numbers
# to the JAX models' own counts on the CPU).
MODEL_PARAMS = {"ResNet18": 11_689_512, "ResNet50": 25_557_032, "VGG16": 138_357_544,
                "ViTBase": 86_567_656, "ECTiedNet": 21_773_865}
MODEL_TOL = 1e-4  # card vs CPU forward, every tap: max |Δ| / the tap's largest |value|
# The pretrained evals: selection taps T (extract_pre_and_post), batch, the
# weight file's seed, and three (port key, torchvision key) pairs that
# must hold the file's values after the import: first layer, a middle
# one, the head.
PRETRAINED = {
    "ResNet50": {"phase": "e2e_resnet50", "taps": 18, "batch": 256, "seed": 11, "probes": [
        ("conv1.weight", "conv1.weight"),
        ("layer3_5.bn2.running_var", "layer3.5.bn2.running_var"),
        ("fc.weight", "fc.weight")]},
    "ViTBase": {"phase": "e2e_vit", "taps": 14, "batch": 256, "seed": 12, "probes": [
        ("conv_proj.weight", "conv_proj.weight"),
        ("encoder_layer_6.mlp_0.weight", "encoder.layers.encoder_layer_6.mlp.0.weight"),
        ("head.weight", "heads.head.weight")]},
    "VGG16": {"phase": "e2e_vgg16", "taps": 30, "batch": 128, "seed": 13, "probes": [
        ("conv1.weight", "features.0.weight"),
        ("conv8.weight", "features.17.weight"),
        ("fc3.weight", "classifier.6.weight")]},
}
REF_CKPT = {"classes": 64, "epoch": 20, "seed": 14}


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


def tolerance(d: int, dtype: str) -> float:
    """The kernel-vs-plain tolerance: TOL, and in f32 beyond d = TOL_WIDTH
    (the widest rows it was set at) growing as √d, as the rounding error
    of an f32 sum of d products does in either version."""
    if dtype != "float32":
        return TOL[dtype]
    return TOL[dtype] * max(1.0, math.sqrt(d / TOL_WIDTH))


def f64_errors(xin, std, out, plain) -> dict:
    """The kernel's and the plain version's max |error| against the same
    RDM from an f64 Gram of the same rows (summed over blocks of 2¹⁸
    columns), to show which side a wide-d difference comes from."""
    import torch

    n, d = xin.shape
    gram = torch.zeros((n, n), dtype=torch.float64, device=xin.device)
    for c in range(0, d, 1 << 18):
        block = xin[:, c:c + (1 << 18)].double()
        gram += block @ block.T
    s = std.double()
    ref = 1.0 - (gram / d / (s[:, None] * s[None, :] + 1e-12)).clamp(-1.0, 1.0)
    ref.fill_diagonal_(0.0)
    return {"f64_err_kernel": (out.double() - ref).abs().max().item(),
            "f64_err_plain": (plain.double() - ref).abs().max().item()}


def check_kernel(xin, std) -> dict:
    """Two kernel calls on these rows: each must count one launch, the
    output must be exactly symmetric with an exactly zero diagonal, the
    two outputs bit-identical, and within ``tolerance`` of the plain
    version. Returns the max |err| and the tolerance, and for f32 rows
    wider than TOL_WIDTH both versions' errors against an f64 Gram."""
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
    plain = rdm_kernel.rdm_from_centered_reference(xin, std)
    err, tol = (out - plain).abs().max().item(), tolerance(d, dtype)
    rec = {"max_abs_err": err, "tol": tol}
    if dtype == "float32" and d > TOL_WIDTH:
        rec.update(f64_errors(xin, std, out, plain))
    if not err <= tol:
        raise RuntimeError(f"rdm kernel disagrees at ({n}, {d}) {dtype}: "
                           f"max |err| {err} > {tol} ({rec})")
    return rec


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
        checked = check_kernel(xin, std)
        ms, host_ms = time_kernel(xin, std)
        device = profile_kernel(xin, std)
        iters = timing_iters(n, d)
        plain_ms = time_ms(lambda: rdm_kernel.rdm_from_centered_reference(xin, std), iters)[0]
        library_ms = time_ms(lambda: torch.corrcoef(xin), iters)[0]
        rec = {"phase": "kernel", "name": "rdm", "n": n, "d": d, "dtype": dtype,
               **checked, "ms": ms, "host_ms": host_ms, **device,
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


def drive(overrides: list[str]) -> dict:
    """One eval through ``run.main`` with configs/eval/base.json, with the
    kernel's launch count set to 0 just before and read just after, and
    the RDM shapes ``compute_rdm`` handed the kernel wrapper counted.
    Returns the results, the launches, the shapes (a Counter of (n, d,
    dtype)), the wall seconds, the eval's phase times and the peak
    device memory (GB)."""
    import torch

    from visreps_tpu_torch import evals, run
    from visreps_tpu_torch.ops import rdm as rdm_ops
    from visreps_tpu_torch.ops import rdm_kernel

    shapes = Counter()
    wrapper = rdm_ops.rdm_from_centered

    def probe(xc, std, correction=1e-12):
        shapes[(xc.shape[0], xc.shape[1], str(xc.dtype).removeprefix("torch."))] += 1
        return wrapper(xc, std, correction)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
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
    return {"results": results, "launches": launches, "shapes": shapes, "seconds": wall,
            "phases": dict(evals.LAST_PHASE_TIMES),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def check_rsa_results(results: list, n_expected: int, n_selection: int) -> None:
    """``n_expected`` results, each with ``n_selection`` selection scores,
    a finite score and CIs, 1000 finite bootstrap scores and
    -1 ≤ ci_low ≤ ci_high ≤ 1."""
    if len(results) != n_expected:
        raise RuntimeError(f"{len(results)} results, expected {n_expected}")
    for r in results:
        vals = [r["score"], r["ci_low"], r["ci_high"], *r["bootstrap_scores"]]
        if len(r["bootstrap_scores"]) != 1000 or not all(math.isfinite(v) for v in vals):
            raise RuntimeError(f"non-finite or missing scores in the {r['layer']} result")
        if not -1.0 <= r["ci_low"] <= r["ci_high"] <= 1.0:
            raise RuntimeError(f"bad CI [{r['ci_low']}, {r['ci_high']}]")
        if len(r["layer_selection_scores"]) != n_selection:
            raise RuntimeError(f"{len(r['layer_selection_scores'])} selection scores, "
                               f"expected {n_selection}")


def check_launches(run: dict, expected: int, rule: str) -> None:
    if run["launches"] != expected or sum(run["shapes"].values()) != expected:
        raise RuntimeError(f"RDM kernel launched {run['launches']} times in the eval for "
                           f"{sum(run['shapes'].values())} RDMs, expected {expected} (= {rule})")


def db_rows(where: str) -> list:
    with sqlite3.connect(os.environ["VISREPS_RESULTS_DB"]) as conn:
        return conn.execute("SELECT region, subject_idx, layer, cfg_id, epoch FROM results "
                            f"WHERE {where}").fetchall()


def eval_record(phase: str, run: dict, n_images: int, fixture_s: float, **extra) -> dict:
    """The line each eval phase prints: wall and phase times, extraction
    images/s and the loader's wait, peak memory, fixture seconds, the
    kernel's launches and the RDM shapes asked for."""
    phases = run["phases"]
    rec = {"phase": phase, "seconds": run["seconds"], "fixture_s": fixture_s,
           "n_images": n_images, "n_results": len(run["results"]),
           "rdm_launches": run["launches"],
           "rdm_shapes": [[*k, v] for k, v in sorted(run["shapes"].items())],
           "phase_times_s": phases, "peak_mem_gb": run["peak_mem_gb"], **extra}
    if "extraction_s" in phases:
        rec["images_per_s"] = n_images / phases["extraction_s"]
        rec["loader_wait_s"] = phases["extraction_loader_s"]
    rec["scores"] = [{"layer": r["layer"], "score": r["score"], "ci": [r["ci_low"], r["ci_high"]]}
                     for r in run["results"]]
    emit(rec)
    return rec


def run_eval(phase: str, meta: dict, source: list[str], db_where: str, expect_row,
             n_taps: int = 14, batch: int = 256, extra: dict | None = None):
    """The NSD RSA eval on the fixture (``drive``); checks results, db rows
    (``db_where`` selects this eval's; ``expect_row`` checks each row's
    (cfg_id, epoch)), ``n_taps`` selection scores per result, finite
    scores and one launch per RDM. ``extra`` (filled while the eval runs)
    joins the printed line. Returns the run (``drive``'s dict)."""
    subjects = list(range(E2E["n_subjects"]))
    regions = NSD_REGIONS[: E2E["n_regions"]]
    run = drive([
        *source, "neural_dataset=nsd", "analysis=rsa", "compare_method=spearman",
        f"subject_idx={json.dumps(subjects)}", f"region={json.dumps(regions)}",
        "bootstrap=true", "n_bootstrap=1000", "n_select=1000", "srp_k=4096",
        "extract_pre_and_post=true", "uint8_transfer=true", "log_expdata=true",
        f"batchsize={batch}", "num_workers=8",
    ])
    results = run["results"]
    n_pairs = len(subjects) * len(regions)
    check_rsa_results(results, n_pairs, n_taps)
    rows = db_rows(db_where)
    if len(rows) != n_pairs or not all(expect_row(*r[3:]) for r in rows):
        raise RuntimeError(f"results.db rows {rows}, expected {n_pairs} of this eval")
    unique_layers = len({r["layer"] for r in results})
    check_launches(run, len(subjects) * (n_taps + len(regions)) + unique_layers + n_pairs,
                   f"S·(T + R) + U + P, T {n_taps}")
    extra = dict(extra or {})
    if "extraction_peak_gb" in extra:  # the peak statistic was reset before phase 2
        extra["phase2_peak_gb"] = run["peak_mem_gb"]
        run["peak_mem_gb"] = max(run["peak_mem_gb"], extra["extraction_peak_gb"])
    eval_record(phase, run, meta["n_stimuli"], meta["fixture_s"], db_rows=rows,
                unique_layers=unique_layers, batch=batch, **extra)
    return run


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


def phase_models() -> None:
    """Each family of this slice at full width from seeded weights: its
    parameter count against the JAX model's, a 2-image forward on the
    card against the CPU's (every tap), and the card's ms per image of an
    all-taps forward at the eval's batch (CUDA events over 3 batches
    after a warm-up)."""
    import torch

    from visreps_tpu_torch.models.zoo import init_model

    x = torch.randn((2, 3, 224, 224), generator=torch.Generator().manual_seed(4))
    failures = []
    for name, n_jax in MODEL_PARAMS.items():
        model = init_model(name, 1000, seed=0, device="cpu")
        points = [p for spec in model.TAPS.values() for p in spec]
        n_params = sum(p.numel() for p in model.parameters())
        with torch.inference_mode():
            _, want = model(x, capture=points)
            model.to("cuda")
            _, got = model(x.to("cuda"), capture=points)
            if set(got) != set(want):
                raise RuntimeError(f"{name}: the card's taps {sorted(got)} are not the CPU's")
            errs = {p: ((got[p].cpu() - want[p]).abs().max() / want[p].abs().max()).item()
                    for p in want}
            batch = PRETRAINED.get(name, {}).get("batch", 256)
            xb = torch.randn((batch, 3, 224, 224), device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(5))
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(lambda: model(xb, capture=points), 3)[0]
        worst = max(errs, key=errs.get)
        emit({"phase": "models", "model": name, "params": n_params, "params_jax": n_jax,
              "taps": len(want), "max_rel_err": errs[worst], "worst_tap": worst,
              "tol": MODEL_TOL, "batch": batch, "forward_ms": ms,
              "ms_per_image": ms / batch, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        if n_params != n_jax:
            failures.append(f"{name}: {n_params} parameters, the JAX model has {n_jax}")
        if not errs[worst] <= MODEL_TOL:
            failures.append(f"{name}: tap {worst} on the card differs from the CPU by "
                            f"{errs[worst]} > {MODEL_TOL}")
        del model, want, got, xb
        torch.cuda.empty_cache()
    if failures:
        raise RuntimeError("; ".join(failures))


def phase_ref_ckpt(meta: dict, tmp: Path) -> dict:
    """A reference whole-module torch-zip checkpoint through
    ``load_checkpoint`` on the card and the CPU, then the e2e eval of it."""
    import torch

    from visreps_tpu_torch.benchmarks.weights import write_reference_checkpoint
    from visreps_tpu_torch.train.checkpoint import load_checkpoint

    k, epoch = REF_CKPT["classes"], REF_CKPT["epoch"]
    run_dir = tmp / "reference_checkpoints" / f"cfg{k}a"
    run_dir.mkdir(parents=True)
    path = run_dir / f"checkpoint_epoch_{epoch}.pth"
    config = {"model_class": "custom_model", "model_name": "CustomCNN", "pca_labels": True,
              "pca_n_classes": k, "seed": 1}
    module = write_reference_checkpoint(path, num_classes=k, seed=REF_CKPT["seed"], epoch=epoch,
                                        config=config)
    (run_dir / "config.json").write_text(json.dumps(config))
    card, payload = load_checkpoint(path, device="cuda")
    cpu, _ = load_checkpoint(path, device="cpu")
    x = torch.randn((8, 3, 224, 224), generator=torch.Generator().manual_seed(6))
    with torch.inference_mode():
        want = module(x)
        on_cpu = cpu(x)[0]
        on_card = card(x.to("cuda"))[0].cpu()
    scale = want.abs().max().item()
    check = {"magic": path.read_bytes()[:2].decode(), "config": payload["config"] == config,
             "classes": card.num_classes, "device": next(card.parameters()).device.type,
             "card_vs_cpu": (on_card - on_cpu).abs().max().item() / scale,
             "cpu_vs_module": (on_cpu - want).abs().max().item() / scale, "tol": MODEL_TOL}
    if not (check["magic"] == "PK" and check["config"] and check["classes"] == k
            and check["device"] == "cuda" and check["card_vs_cpu"] <= MODEL_TOL
            and check["cpu_vs_module"] <= MODEL_TOL):
        raise RuntimeError(f"reference checkpoint load failed its checks: {check}")
    del card, cpu
    return run_eval("ref_ckpt", meta, [
        "load_model_from=checkpoint", f"cfg_id={k}", f"checkpoint_dir={run_dir.parent}",
        f"checkpoint_model={path.name}"], f"cfg_id = {k}",
        lambda cfg_id, ep: cfg_id == k and ep == epoch, extra={"load_check": check})


def phase_pretrained(meta: dict, tmp: Path, name: str) -> dict:
    """The e2e eval of ``name`` with ``pretrained_dataset=imagenet1k``,
    its weights from a seeded torchvision-layout file; checks that the
    import took the file's values, and records the memory of the
    extraction and of phase 2."""
    import torch

    from visreps_tpu_torch import evals
    from visreps_tpu_torch.benchmarks.weights import write_torchvision_weights
    from visreps_tpu_torch.models.extractor import FeatureExtractor

    spec = PRETRAINED[name]
    t0 = time.perf_counter()
    path = write_torchvision_weights(tmp / "torch_weights", name, seed=spec["seed"])
    extra = {"model": name, "weight_file": path.name, "weight_file_mb": path.stat().st_size / 1e6,
             "weight_file_s": time.perf_counter() - t0}
    os.environ["TORCH_WEIGHTS_DIR"] = str(path.parent)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    want = {mine: sd[theirs].clone() for mine, theirs in spec["probes"]}
    del sd
    load_model, exact = evals.load_model, FeatureExtractor.extract_layers_exact

    def load(cfg, **kwargs):
        model = load_model(cfg, **kwargs)
        state = model.state_dict()
        same = {k: torch.equal(state[k].cpu(), v) for k, v in want.items()}
        extra["weights_from_file"] = same
        if not all(same.values()):
            raise RuntimeError(f"{name}: the loaded weights are not the file's: {same}")
        return model

    def exact_probe(self, loader, layer_names, stimulus_ids=None):
        dims = set(self.tap_dims.values())
        extra.update({
            "tap_floats_per_image": sum(self.tap_dims.values()),
            "srp_matrices_gb": sum(2 * d * self.srp.out_dim(d) for d in dims) / 1e9,
            "extraction_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "exact_layers": {l: self.tap_dims[l] for l in layer_names},
            "exact_gb": sum(4 * len(loader.dataset) * self.tap_dims[l] for l in layer_names) / 1e9,
            "centred_copy_gb": max(4 * len(loader.dataset) * self.tap_dims[l]
                                   for l in layer_names) / 1e9})
        torch.cuda.reset_peak_memory_stats()
        return exact(self, loader, layer_names, stimulus_ids)

    evals.load_model, FeatureExtractor.extract_layers_exact = load, exact_probe
    try:
        run = run_eval(spec["phase"], meta, [
            "load_model_from=torchvision", f"model_name={name}", "pretrained_dataset=imagenet1k"],
            f"cfg_id = 'pretrained' AND model_name = '{name}'",
            lambda cfg_id, epoch: cfg_id == "pretrained" and epoch == -1,
            n_taps=spec["taps"], batch=spec["batch"], extra=extra)
    finally:
        evals.load_model, FeatureExtractor.extract_layers_exact = load_model, exact
        del os.environ["TORCH_WEIGHTS_DIR"]
    return run


RSA_OVERRIDES = ["load_model_from=torchvision", "model_name=AlexNet", "pretrained_dataset=none",
                 "analysis=rsa", "compare_method=spearman", "bootstrap=true",
                 "n_bootstrap=1000", "srp_k=4096", "extract_pre_and_post=true",
                 "log_expdata=true", "num_workers=16"]


def phase_things(tmp: Path) -> dict:
    """The THINGS eval (stage_things_e2e's configuration) on its fixture:
    1,854 concepts × 14 JPEGs, 66-d embeddings. Checks one result and one
    results.db row with region and subject "N/A", 14 selection scores,
    finite scores and 1000 bootstrap scores, 370 selection and 1,484
    evaluation concepts, the store, the concept means and the selected
    layer's re-extracted means on the card, and 14 + 1 + 2 RDM launches."""
    import torch

    from visreps_tpu_torch import evals
    from visreps_tpu_torch.benchmarks import fixture
    from visreps_tpu_torch.models.extractor import FeatureExtractor

    t0 = time.perf_counter()
    meta = fixture.ensure_things_fixture(tmp / "fixture", **THINGS)
    fixture_s = time.perf_counter() - t0
    seen = Counter()
    originals = {"prepare": evals.prepare_concept_alignment,
                 "align": evals.compute_traintest_alignment,
                 "mean": FeatureExtractor.extract_single_layer_mean,
                 "single": FeatureExtractor.extract_single_layer}

    def prepare(cfg, acts, *args):
        seen.update(f"store {a.device.type} {a.dtype}" for a in acts.values())
        out = originals["prepare"](cfg, acts, *args)
        seen.update(f"concept means {a.device.type} {a.dtype}" for a in out.activations.values())
        return out

    def align(cfg, selection, evaluation, **kwargs):
        seen[f"concepts {selection.neural.shape[0]} / {evaluation.neural.shape[0]}"] += 1
        return originals["align"](cfg, selection, evaluation, **kwargs)

    def mean(self, *args, **kwargs):
        out = originals["mean"](self, *args, **kwargs)
        seen[f"re-extracted means {out[0].device.type} {tuple(out[0].shape)}"] += 1
        return out

    def single(self, *args, **kwargs):
        seen["host re-extraction"] += 1
        return originals["single"](self, *args, **kwargs)

    cwd = os.getcwd()
    os.chdir(meta["root"])  # the loader reads datasets/neural/things/ relative to it
    evals.prepare_concept_alignment, evals.compute_traintest_alignment = prepare, align
    FeatureExtractor.extract_single_layer_mean = mean
    FeatureExtractor.extract_single_layer = single
    try:
        run = drive([*RSA_OVERRIDES, "neural_dataset=things-behavior", "uint8_transfer=true",
                     "batchsize=512"])
    finally:
        os.chdir(cwd)
        evals.prepare_concept_alignment = originals["prepare"]
        evals.compute_traintest_alignment = originals["align"]
        FeatureExtractor.extract_single_layer_mean = originals["mean"]
        FeatureExtractor.extract_single_layer = originals["single"]
    check_rsa_results(run["results"], 1, 14)
    rows = db_rows("neural_dataset = 'things-behavior'")
    problems = []
    if len(rows) != 1 or rows[0][:2] != ("N/A", "N/A"):
        problems.append(f"results.db rows {rows}, expected one with region and subject N/A")
    expected_seen = {"store cuda torch.bfloat16": 14, "concept means cuda torch.float32": 14,
                     "concepts 370 / 1484": 1}
    on_card = sum(v for k, v in seen.items() if k.startswith("re-extracted means cuda (1484,"))
    if any(seen[k] != v for k, v in expected_seen.items()) or on_card != 1 \
            or seen["host re-extraction"]:
        problems.append(f"store, means or concepts off the card or miscounted: {dict(seen)}")
    if problems:
        raise RuntimeError("; ".join(problems))
    check_launches(run, 14 + 1 + 2, "14 selection + 1 embedding + 2 evaluation RDMs")
    eval_record("things", run, meta["n_images"], fixture_s, n_concepts=meta["n_concepts"],
                n_jpeg=meta["n_jpeg"], db_rows=rows, probes=dict(seen))
    return run


def phase_tvsd(tmp: Path) -> dict:
    """The TVSD eval (stage_tvsd_e2e's configuration): 22,248 train + 100
    test JPEGs, 2 monkeys × V1/V4/IT × 256 sites, n_select 1000. Checks 6
    results and 6 rows and S·(14 + R) + U + P RDM launches."""
    from visreps_tpu_torch.benchmarks import fixture

    t0 = time.perf_counter()
    meta = fixture.ensure_tvsd_fixture(tmp / "fixture", **TVSD)
    fixture_s = time.perf_counter() - t0
    cwd, home = os.getcwd(), os.environ.get("BONNER_DATASETS_HOME")
    os.chdir(meta["root"])  # the loader reads datasets/neural/tvsd/ relative to it
    os.environ["BONNER_DATASETS_HOME"] = meta["bonner_home"]
    try:
        run = drive([*RSA_OVERRIDES, "neural_dataset=tvsd", "subject_idx=[0,1]",
                     'region=["V1","V4","IT"]', "n_select=1000", "uint8_transfer=true",
                     "batchsize=512"])
    finally:
        os.chdir(cwd)
        if home is None:
            os.environ.pop("BONNER_DATASETS_HOME", None)
        else:
            os.environ["BONNER_DATASETS_HOME"] = home
    check_rsa_results(run["results"], 6, 14)
    rows = db_rows("neural_dataset = 'tvsd'")
    if len(rows) != 6:
        raise RuntimeError(f"results.db has {len(rows)} TVSD rows, expected 6")
    unique_layers = len({r["layer"] for r in run["results"]})
    check_launches(run, 2 * (14 + 3) + unique_layers + 6, "S·(taps + R) + U + P, S 2, R 3, P 6")
    eval_record("tvsd", run, meta["n_train"] + meta["n_test"], fixture_s,
                n_jpeg=meta["n_jpeg"], unique_layers=unique_layers, db_rows=rows)
    return run


def phase_nsd_synthetic(tmp: Path, e2e_results: list) -> dict:
    """The NSD-Synthetic eval (stage_nsd_synthetic_e2e's configuration):
    220 PNG stimuli × 8 subjects × 6 regions × 512 voxels, over the
    results.db the e2e phase wrote. Its 4 pairs (subjects 0–1 × early and
    ventral) inherit e2e's selected layers; the other 44 are seeded with
    conv5_post as the JAX stage seeds them. Checks 48 results and rows,
    the 4 inherited layers, and U + 48 RDM launches."""
    from visreps_tpu_torch import run as run_mod
    from visreps_tpu_torch.benchmarks import fixture
    from visreps_tpu_torch.core.config import load_config
    from visreps_tpu_torch.core.db import save_results

    t0 = time.perf_counter()
    meta = fixture.ensure_nsd_synthetic_fixture(tmp / "fixture", **NSD_SYNTHETIC)
    fixture_s = time.perf_counter() - t0
    os.environ["NSD_SYNTHETIC_DATA_DIR"] = meta["root"]
    subjects = list(range(NSD_SYNTHETIC["n_subjects"]))
    overrides = [*RSA_OVERRIDES, "neural_dataset=nsd_synthetic", "batchsize=256",
                 f"subject_idx={json.dumps(subjects)}", f"region={json.dumps(NSD_REGIONS)}"]
    cfg = run_mod.validate_config(load_config(ROOT / "configs/eval/base.json",
                                              [*overrides, "mode=eval"]))
    cfg.epoch, cfg.cfg_id = -1, "untrained"  # as the eval sets them for torchvision
    e2e_pairs = [(r, s) for r in NSD_REGIONS[: E2E["n_regions"]] for s in range(E2E["n_subjects"])]
    inherited = {pair: r["layer"] for pair, r in zip(e2e_pairs, e2e_results)}
    for region in NSD_REGIONS:
        for subj in subjects:
            if (region, subj) not in inherited:
                save_results([{"layer": "conv5_post", "compare_method": "spearman", "score": 0.5,
                               "ci_low": 0.45, "ci_high": 0.55, "analysis": "rsa",
                               "layer_selection_scores": []}],
                             cfg.merge({"neural_dataset": "nsd", "analysis": "rsa",
                                        "subject_idx": subj, "region": region}))
    run = drive(overrides)
    results = run["results"]
    check_rsa_results(results, 48, 0)
    pairs = [(r, s) for r in NSD_REGIONS for s in subjects]
    got = {pair: r["layer"] for pair, r in zip(pairs, results)}
    rows = db_rows("neural_dataset = 'nsd_synthetic'")
    problems = []
    if any(got[p] != layer for p, layer in inherited.items()):
        problems.append(f"inherited layers {[got[p] for p in inherited]}, e2e selected "
                        f"{list(inherited.values())}")
    if any(got[p] != "conv5_post" for p in pairs if p not in inherited):
        problems.append("a seeded pair did not score conv5_post")
    if len(rows) != 48:
        problems.append(f"results.db has {len(rows)} NSD-Synthetic rows, expected 48")
    if problems:
        raise RuntimeError("; ".join(problems))
    unique_layers = len(set(got.values()))
    check_launches(run, unique_layers + 48, "U + P, P 48")
    eval_record("nsd_synthetic", run, meta["n_stimuli"], fixture_s, unique_layers=unique_layers,
                inherited={f"{r}|{s}": layer for (r, s), layer in inherited.items()})
    return run


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
    """The kernel's time on the main path: at each RDM shape the evals
    asked for, its launches there times its ms per call. A shape the
    kernel phase did not check is checked here as there (``check_kernel``)
    and timed, with the plain version's and torch.corrcoef's times; its
    max |err| joins ``records``' in the summary line."""
    import torch

    seen = {(r["n"], r["d"], r["dtype"]): r for r in records}
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for (n, d, dtype), count in sorted(shapes.items()):
        rec = seen.get((n, d, dtype))
        if rec is None:
            from visreps_tpu_torch.ops import rdm_kernel

            xin, std = random_rows(n, d, dtype, gen)
            iters = timing_iters(n, d)
            rec = {"n": n, "d": d, "dtype": dtype, **check_kernel(xin, std),
                   "ms": time_kernel(xin, std)[0],
                   "plain_ms": time_ms(lambda: rdm_kernel.rdm_from_centered_reference(xin, std),
                                       iters)[0],
                   "library_ms": time_ms(lambda: torch.corrcoef(xin), iters)[0],
                   **launch_plan(xin)}
            del xin, std
            torch.cuda.empty_cache()
        rows.append({"n": n, "d": d, "dtype": dtype, "launches": count,
                     "checked_here": (n, d, dtype) not in seen,
                     **{k: rec[k] for k in ("ms", "plain_ms", "library_ms", "max_abs_err", "tol",
                                            "tiles", "splits")},
                     **bound(n, d, dtype)})
    total = sum(r["launches"] * r["ms"] for r in rows)
    emit({"phase": "path", "shapes": rows, "kernel_ms_on_path": total,
          "bound_ms_on_path": sum(r["launches"] * r["bound_ms"] for r in rows)})
    records.extend(r for r in rows if r["checked_here"])
    return total


def wood_cv_ops(n: int, d: int, v: int, n_alphas: int = 20,
                n_folds: int = 5) -> tuple[float, float]:
    """Operations of ``ridge._wood_cv_scores`` at these shapes, 2·m·n·k per
    product: (the v-wide products ``high`` runs on TF32, the f32 rest).

    TF32 at ``high``, per fold and alpha: r1 = uᵀ·c1 (nv·d·v), inv(s)·r1
    and K·z (nv²·v each). f32: Vᵀc (d²·v), per fold u (d²·nv) and Vᵀc_f
    (d·nv·v), per fold and alpha K (nv²·d) and inv(s) (≈ 2·nv³)."""
    from visreps_tpu_torch.ops.ridge import _kfold_bounds

    nvs = [stop - start for start, stop in _kfold_bounds(n, n_folds)]
    sweep = sum(n_alphas * 2.0 * (nv * d * v + 2 * nv * nv * v) for nv in nvs)
    f32 = 2.0 * d * d * v + sum(2.0 * (d * d * nv + d * nv * v)
                                + n_alphas * 2.0 * (nv * nv * d + nv ** 3) for nv in nvs)
    return sweep, f32


def ridge_ops(n: int, d: int, v: int, n_pred: int) -> tuple[float, float]:
    """Operations of one Woodbury RidgeCV fit and prediction at these
    shapes, as ``ops/ridge.py`` computes it: the CV sweep (``wood_cv_ops``)
    plus, in f32, the Gram (n·d²), its eigh (≈ 10/3·d³: tridiagonalisation
    and back-transformation), c = xᵀy (n·d·v), the weights (2 × d²·v) and
    the prediction of n_pred rows (n_pred·d·v)."""
    sweep, f32 = wood_cv_ops(n, d, v)
    return sweep, f32 + 2.0 * (n * d * d + n * d * v + 2 * d * d * v + n_pred * d * v) \
        + 10 / 3 * d ** 3


def ops_bound(fits: list, precision: str) -> dict:
    """Σ operations of ``fits`` [(n, d, v, n_pred), ...] and the least
    time the card could take: at ``highest`` all of them over the f32
    FMA peak, at ``high`` the sweep over the TF32 peak plus the rest over
    the f32 peak."""
    sweep = f32 = 0.0
    for fit in fits:
        a, b = ridge_ops(*fit)
        sweep, f32 = sweep + a, f32 + b
    if precision == "highest":
        bound = (sweep + f32) / FMA_PEAK_OPS["float32"]
    else:
        bound = sweep / TF32_PEAK_OPS + f32 / FMA_PEAK_OPS["float32"]
    return {"fits": len(fits), "sweep_tflop": sweep / 1e12, "f32_tflop": f32 / 1e12,
            "bound_s": bound, "precision": precision}


def time_linalg() -> dict:
    """At one selection fit's NSD shapes (7,200 fit rows, d 4096, 15,208
    voxels): ms per f32 eigh of the (4096, 4096) Gram, alone (CUDA events
    over 3 calls after a warm-up) and in a batch of 14 (one call); 20
    inverses of (1440, 1440) systems (one fold's 20 alphas) one by one
    against one batched call; and the Woodbury CV sweep
    (``ridge._wood_cv_scores``) at ``high`` and ``highest``, beside its
    bounds."""
    import torch

    from visreps_tpu_torch.ops import ridge

    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((7200, 4096), device="cuda", generator=gen)
    g = x.T @ x
    eigh_ms = time_ms(lambda: torch.linalg.eigh(g), 3)[0]
    y = torch.randn((7200, 15208), device="cuda", generator=gen)
    lam, v_eig = ridge._gram_eigh(g)
    c = x.T @ y
    alphas = torch.as_tensor(ridge.default_alphas(), dtype=torch.float32, device="cuda")
    sweep_ms = {p: time_ms(lambda: ridge._wood_cv_scores(x, y, lam, v_eig, c, alphas, 5, p), 1)[0]
                for p in ("high", "highest")}
    tf32_ops, f32_ops = wood_cv_ops(7200, 4096, 15208)
    del y, lam, v_eig, c
    batch = g.expand(14, -1, -1).contiguous()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.linalg.eigh(batch)
    stop.record()
    torch.cuda.synchronize()
    batch_ms = start.elapsed_time(stop) / 14
    del x, g, batch
    u = torch.randn((20, 1440, 1440), device="cuda", generator=gen) / 1440 ** 0.5
    s = torch.eye(1440, device="cuda") + u @ u.mT
    one_by_one = time_ms(lambda: [torch.linalg.inv_ex(s[i]) for i in range(20)], 3)[0]
    batched = time_ms(lambda: torch.linalg.inv_ex(s), 3)[0]
    del u, s
    torch.cuda.empty_cache()
    return {"eigh_4096_ms": eigh_ms, "eigh_4096_ms_in_batch_of_14": batch_ms,
            "inv_1440_x20_ms_one_by_one": one_by_one, "inv_1440_x20_ms_batched": batched,
            "wood_cv_ms": sweep_ms, "wood_cv_tflop": {"sweep": tf32_ops / 1e12,
                                                      "f32": f32_ops / 1e12},
            "wood_cv_bound_ms": {
                "high": 1e3 * (tf32_ops / TF32_PEAK_OPS + f32_ops / FMA_PEAK_OPS["float32"]),
                "highest": 1e3 * (tf32_ops + f32_ops) / FMA_PEAK_OPS["float32"]}}


def phase_encoding(tmp: Path) -> None:
    """The encoding-score eval through ``run.main`` on its own NSD-count
    fixture; checks results, rows, scores, devices and route."""
    import torch

    from visreps_tpu_torch import evals, run
    from visreps_tpu_torch.analysis import encoding
    from visreps_tpu_torch.benchmarks import fixture
    from visreps_tpu_torch.ops import rdm_kernel, ridge

    t0 = time.perf_counter()
    meta = fixture.ensure_fixture(tmp / "encoding_fixture", **ENCODING)
    fixture_s = time.perf_counter() - t0
    os.environ["NSD_DATA_DIR"] = str(Path(meta["pickle"]).parent)
    os.environ["NSD_STIMULI_HDF5"] = meta["stimuli"]
    subjects = list(range(ENCODING["n_subjects"]))
    regions = ["early visual stream", "ventral visual stream"][: ENCODING["n_regions"]]

    calls, tensor_devices, store = Counter(), set(), {}
    originals = {name: getattr(ridge, name) for name in ("_wood_cv_scores", "_ridge_cv_impl",
                                                          "_gram_eigh", "_weights")}
    subjects_fn = encoding.compute_encoding_scores_subjects

    def probe(name):
        def call(*args, **kwargs):
            calls[name] += 1
            tensor_devices.update(a.device.type for a in args if isinstance(a, torch.Tensor))
            return originals[name](*args, **kwargs)
        return call

    def probe_store(subject_inputs, **kwargs):
        for a_tr, a_te, _, _ in subject_inputs.values():
            for t in (*a_tr.values(), *a_te.values()):
                store.setdefault("devices", set()).add(t.device.type)
                store.setdefault("dtypes", set()).add(str(t.dtype).removeprefix("torch."))
        return subjects_fn(subject_inputs, **kwargs)

    overrides = [
        "load_model_from=torchvision", "model_name=AlexNet", "pretrained_dataset=none",
        "neural_dataset=nsd", "analysis=encoding_score", "encoding_cv_precision=high",
        f"subject_idx={json.dumps(subjects)}", f"region={json.dumps(regions)}",
        "bootstrap=true", "n_bootstrap=1000", "srp_k=4096", "extract_pre_and_post=true",
        "uint8_transfer=true", "log_expdata=true", "batchsize=256", "num_workers=8",
    ]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for name in originals:
        setattr(ridge, name, probe(name))
    encoding.compute_encoding_scores_subjects = probe_store
    try:
        rdm_kernel.LAUNCHES = 0
        t0 = time.perf_counter()
        results = run.main(["--mode", "eval", "--config", str(ROOT / "configs/eval/base.json"),
                            "--override", *overrides])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rdm_launches = rdm_kernel.LAUNCHES
    finally:
        for name, fn in originals.items():
            setattr(ridge, name, fn)
        encoding.compute_encoding_scores_subjects = subjects_fn
    peak = torch.cuda.max_memory_allocated() / 1e9

    n_pairs = len(subjects) * len(regions)
    if len(results) != n_pairs:
        raise RuntimeError(f"{len(results)} encoding results, expected {n_pairs}")
    with sqlite3.connect(os.environ["VISREPS_RESULTS_DB"]) as conn:
        rows = conn.execute("SELECT region, subject_idx, layer, score, ci_low, ci_high "
                            "FROM results WHERE analysis = 'encoding_score'").fetchall()
    if len(rows) != n_pairs:
        raise RuntimeError(f"results.db has {len(rows)} encoding rows, expected {n_pairs}")
    for r in results:
        vals = [r["score"], r["ci_low"], r["ci_high"], *r["bootstrap_scores"]]
        if len(r["layer_selection_scores"]) != 14 or len(r["bootstrap_scores"]) != 1000:
            raise RuntimeError(f"encoding result without 14 selection / 1000 bootstrap scores")
        if not all(math.isfinite(v) for v in vals):
            raise RuntimeError(f"non-finite encoding score or CI in the {r['layer']} result")
        if not -1.0 <= r["ci_low"] <= r["ci_high"] <= 1.0:
            raise RuntimeError(f"bad encoding CI [{r['ci_low']}, {r['ci_high']}]")
    # results are subject-major; one refit job per unique layer of a subject's
    # regions, predicting all of their voxels
    job_v = Counter((subjects[i // len(regions)], r["layer"]) for i, r in enumerate(results))
    jobs = {job: members * ENCODING["n_voxels"] for job, members in job_v.items()}
    n_sel = len(subjects) * 14
    problems = []
    if store.get("devices") != {"cuda"} or tensor_devices != {"cuda"}:
        problems.append(f"store on {store.get('devices')}, ridge tensors on {tensor_devices}")
    if calls["_ridge_cv_impl"] or calls["_wood_cv_scores"] != n_sel + len(jobs):
        problems.append(f"route: {dict(calls)}, expected {n_sel + len(jobs)} Woodbury sweeps "
                        f"and no per-fold eigh")
    if rdm_launches:
        problems.append(f"the encoding eval launched the RDM kernel {rdm_launches} times")

    phases = dict(evals.LAST_PHASE_TIMES)
    n_train, n_test = ENCODING["n_unique"], ENCODING["n_shared"]
    n_fit = int(0.8 * n_train)
    v_all = len(regions) * ENCODING["n_voxels"]
    sel_fits = [(n_fit, 4096, v_all, n_train - n_fit)] * n_sel
    refit_fits = [(n_train, 4096, v, n_test) for v in jobs.values()]
    emit({"phase": "encoding", "seconds": wall, "fixture_s": fixture_s,
          "n_stimuli": meta["n_stimuli"], "voxels_per_region": ENCODING["n_voxels"],
          "n_results": len(results), "db_rows": rows,
          "store": {k: sorted(v) for k, v in store.items()},
          "ridge_tensor_devices": sorted(tensor_devices), "ridge_calls": dict(calls),
          "refit_jobs": [[s, l, v] for (s, l), v in jobs.items()], "rdm_launches": rdm_launches,
          "images_per_s": meta["n_stimuli"] / phases["extraction_s"],
          "phase_times_s": phases, "encoding_phase_times_s": dict(encoding.LAST_PHASE_TIMES),
          "selection_ops": {**ops_bound(sel_fits, "high"),
                            "bound_s_highest": ops_bound(sel_fits, "highest")["bound_s"],
                            "measured_s": phases["encoding_selection_s"]},
          "refit_ops": {**ops_bound(refit_fits, "high"),
                        "bound_s_highest": ops_bound(refit_fits, "highest")["bound_s"],
                        "measured_s": phases["encoding_refit_s"]},
          "peak_mem_gb": peak,
          "scores": [{"layer": r["layer"], "score": r["score"], "ci": [r["ci_low"], r["ci_high"]],
                      "selection": [e["score"] for e in r["layer_selection_scores"]]}
                     for r in results], "problems": problems})
    if problems:
        raise RuntimeError("; ".join(problems))
    del results
    torch.cuda.empty_cache()
    emit({"phase": "encoding_linalg", **time_linalg()})


def planted_subject(n_train: int, d: int, seed: int = 0):
    """One subject's 3 taps and 2 regions' responses, y = tap3·W + noise
    (numpy RandomState(seed)), split into train and test rows."""
    import numpy as np

    rng = np.random.RandomState(seed)
    n = n_train + ENC_CHECK["n_test"]
    taps = {f"tap{i + 1}": rng.randn(n, d).astype(np.float32) for i in range(ENC_CHECK["taps"])}
    ys = {}
    for region in ("regA", "regB"):
        w = (rng.randn(d, ENC_CHECK["voxels"]) / np.sqrt(d)).astype(np.float32)
        ys[region] = taps["tap3"] @ w + rng.randn(n, ENC_CHECK["voxels"]).astype(np.float32)
    return ({l: a[:n_train] for l, a in taps.items()}, {l: a[n_train:] for l, a in taps.items()},
            {r: y[:n_train] for r, y in ys.items()}, {r: y[n_train:] for r, y in ys.items()})


def compare_encoding(got: dict, ref: dict) -> dict:
    """Per-region layers and the largest |difference| of scores, CIs and
    selection scores between two compute_encoding_scores_subject outputs."""
    out = {"same_layers": all(got[r][0]["layer"] == ref[r][0]["layer"] for r in ref)}
    for key in ("score", "ci_low", "ci_high"):
        out[key] = max(abs(got[r][0][key] - ref[r][0][key]) for r in ref)
    out["selection"] = max(abs(g["score"] - e["score"]) for r in ref for g, e in zip(
        got[r][0]["layer_selection_scores"], ref[r][0]["layer_selection_scores"]))
    out["layers"] = [got[r][0]["layer"] for r in ref]
    return out


def phase_encoding_check() -> None:
    """Card against CPU at "highest", and "high" against "highest" on the
    card, on both solver routes."""
    from visreps_tpu_torch.analysis import encoding
    from visreps_tpu_torch.ops import ridge

    protocol_alphas = ridge.default_alphas
    determined = protocol_alphas()[protocol_alphas() >= 1]

    def run(data, device, precision):
        t0 = time.perf_counter()
        out = encoding.compute_encoding_scores_subject(
            *data, n_bootstrap=ENC_CHECK["n_bootstrap"], cv_precision=precision, device=device)
        return out, time.perf_counter() - t0

    failures = []
    for route, (n_train, d) in ENC_CHECK["routes"].items():
        if ridge._woodbury_ok(int(0.8 * n_train), d, 5) != (route == "woodbury"):
            raise RuntimeError(f"({n_train}, {d}) does not take the {route} route")
        data = planted_subject(n_train, d)
        rec = {"phase": "encoding_check", "route": route, "n_train": n_train, "d": d}
        if route == "eigh":  # the protocol's 20 alphas: informational (roundoff-decided)
            cpu, _ = run(data, "cpu", "highest")
            rec["all_alphas_cuda_vs_cpu"] = compare_encoding(run(data, "cuda", "highest")[0], cpu)
        patched = route == "eigh"
        if patched:
            ridge.default_alphas = encoding.default_alphas = lambda n=20: determined.copy()
        try:
            cpu, rec["cpu_s"] = run(data, "cpu", "highest")
            highest, rec["cuda_highest_s"] = run(data, "cuda", "highest")
            high, rec["cuda_high_s"] = run(data, "cuda", "high")
        finally:
            if patched:
                ridge.default_alphas = encoding.default_alphas = protocol_alphas
        rec["alphas"] = "alphas >= 1" if patched else "logspace(-10, 10, 20)"
        rec["cuda_vs_cpu"] = compare_encoding(highest, cpu)
        rec["high_vs_highest"] = compare_encoding(high, highest)
        emit(rec)
        c, h = rec["cuda_vs_cpu"], rec["high_vs_highest"]
        if not (c["same_layers"] and max(c["score"], c["ci_low"], c["ci_high"]) <= ENC_TOL):
            failures.append(f"{route}: card vs CPU {c} (tolerance {ENC_TOL})")
        if not (h["same_layers"] and h["score"] <= ENC_HIGH_TOL):
            failures.append(f"{route}: high vs highest {h} (tolerance {ENC_HIGH_TOL})")
    if failures:
        raise RuntimeError("; ".join(failures))


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
    phase_models()
    tmp = Path(tempfile.mkdtemp(prefix="visreps_chip_smoke_"))
    try:
        meta = nsd_fixture(tmp)
        rsa_runs = [phase_e2e(meta)]
        checkpoint_dir = phase_train(tmp)
        phase_train_step()
        rsa_runs.append(phase_e2e_ckpt(meta, checkpoint_dir))
        rsa_runs.append(phase_things(tmp))
        rsa_runs.append(phase_tvsd(tmp))
        rsa_runs.append(phase_nsd_synthetic(tmp, rsa_runs[0]["results"]))
        rsa_runs.append(phase_ref_ckpt(meta, tmp))
        rsa_runs.extend(phase_pretrained(meta, tmp, name) for name in PRETRAINED)
        phase_path(sum((r["shapes"] for r in rsa_runs), Counter()), records)
        phase_encoding(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_encoding_check()
    launches = sum(r["launches"] for r in rsa_runs)

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
