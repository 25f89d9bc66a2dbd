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
  5a. retain — the e2e eval with ``acts_retain=true``: only the phase-1
     plan's rows are kept (2,000 of 3,000). Its results must equal e2e's
     bit for bit; prints the kept rows, the store's GB against the
     unretained store's, the peak memory and the launches.
  5b. procs — ``run.main(["--mode", "eval", "--procs", "2", ...])`` in
     e2e's configuration: one worker process per subject on the card,
     both writing a fresh results.db. The rows, read back through
     ``explore_results``, must cover every (subject, region) and hold
     e2e's layers and scores (largest difference printed; equal bits
     expected); prints the wall and each worker's exit code.
  6. train — ``run.main(["--mode", "train", ...])`` with
     configs/train/base.json and PCA labels (CustomCNN at 224 px,
     pca_n_classes 32, AdamW, batch 256) on a synthetic on-disk ImageNet
     of 1600 JPEGs (1280 train images: 5 steps per epoch), two epochs.
     Checks finite losses and gradient norms, that the model and the
     batches were on the card, the checkpoint files, and that epoch 2's
     checkpoint loads back bit-identically; prints the loss per step,
     ms per step (CUDA events, steps 2–10), images/s, the seconds the
     step loop waited on the loader, the images its loaders served by
     decode route (``data/loader.ROUTES``) and peak device memory.
  7. train_step — the train step alone (CustomCNN, 1000 classes, batch
     256 on the card, AdamW): ms per step over 8 steps after a warm-up,
     images/s, peak memory, and its bound (3 × the forward's operations
     over the f32 FMA peak). Holds one step at batch 8 without dropout on
     the card against the same step on the CPU (loss and gradient norm
     within rtol 1e-4, BN running statistics within 1e-4 of each
     tensor's largest value).
  7a. train_families — the train step of VGG16, ResNet18, ResNet50,
     ViT-B/16 and ECTiedNet at full width (1000 classes, batch 256,
     AdamW) in f32 and in the JAX package's bf16 compute
     (``train_compute_dtype=bf16``: bf16 copies of the f32 parameters and
     the images, f32 loss, f32 optimizer state and BatchNorm statistics):
     ms per step over 5 steps after a warm-up, images/s, peak memory and
     the bound (3 × the forward's FLOPs from ``torch.utils.flop_counter``
     × batch over the f32 FMA peak or the bf16 tensor-core peak; every
     family fits at 256). Parameters and optimizer
     state must stay f32. Each family's f32 step at batch 8 without
     dropout on the card against the CPU's (loss, gradient norm and BN
     running statistics within rtol 1e-4). Also whether ``F.batch_norm``
     on the card takes bf16 affine parameters beside f32 statistics.
  8. e2e_ckpt — the e2e eval again, of the checkpoint the train phase
     wrote (``load_model_from=checkpoint``, cfg_id 32, epoch 2), with the
     same checks; its rows must carry cfg_id 32 and epoch 2.
  8'. train_resume — ResNet18 through ``Trainer`` on the train phase's
     JPEGs (PCA labels, 4 classes, batch 256, AdamW, 2 epochs,
     ``save_resume_state``, a checkpoint every epoch); then a second
     Trainer from a copy of its directory with ``resume_from_epoch=1``:
     it must start at epoch 2, step 10, with epoch 1's saved optimizer
     state, and every step's batch and model on the card. Prints epoch
     2's losses of both runs, then runs the e2e eval of the resumed
     run's epoch-2 checkpoint (cfg_id 4, epoch 2, 10 taps) with e2e's
     checks.
  8a. trace — ``core/profiling.trace`` (torch.profiler, CPU and CUDA)
     around the e2e eval (with e2e's checks, as trace_e2e) and around 10
     trainer steps in train_step's configuration (CustomCNN, 1000
     classes, batch 256, AdamW, on the train phase's JPEGs, no
     evaluation). For each: the device's busy share (the union of kernel,
     memcpy and memset intervals over the traced window), the five device
     operations that took the most time, the five longest idle gaps with
     the host operation across each, and the trace's size.
  8b. runners — ``runners/train_runner`` over seed 1 × pca_n_classes
     [4] (1 epoch on the train phase's JPEGs; one combo, the depth cut),
     then ``runners/eval_runner`` over its checkpoint (e2e's
     configuration, eval_checkpoint_at_epoch 1): two ``python -m
     visreps_tpu_torch.run`` subprocesses on the card. Checks both
     runners' exit codes, the checkpoint file and 4 results.db rows at
     epoch 1.
  8c. decode — whether the C++ JPEG/PNG decoder (``native/``, g++ with
     libjpeg and libpng) builds here, with the compiler's message when it
     does not; where it builds, ``decode_batch`` and ``decode_batch_u8``
     against the port's PIL transform on THINGS' pool (normalised: mean
     |Δ| < 0.02, max < 0.15; uint8: mean < 2, max ≤ 40 gray levels); and
     the images/s of each route that runs here through the eval's loader
     (2,048 images, batch 512, 16 workers, cache off).
  9. things — the THINGS eval (the JAX bench's stage_things_e2e:
     untrained AlexNet, 14 taps, SRP k=4096, Spearman, 1000 bootstraps,
     uint8 transfer, results.db) on a fixture of 1,854 concepts × 14
     images (25,956 ids over a pool of 4,096 distinct 256 px JPEGs) and
     66-d embeddings. Checks one result and one results.db row with
     region and subject "N/A", 14 selection scores, finite scores and
     1000 bootstrap scores, 370 selection / 1,484 evaluation concepts,
     the store, the concept means and the selected layer's re-extracted
     means on the card, and 14 + 1 + 2 RDM launches. The decode cache
     holds all 25,956 ids after the first pass and the re-extraction
     decodes none (every batch from the cache); prints each pass's decode
     routes, the cache's entries and bytes, scoring_re_extract_s and the
     host's peak RSS.
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
 11a. scripts — e2e's NSD pickle and the TVSD
     fixture's split into per-(region, subject) npz files, rebuilt by the
     port's ``preprocess_nsd from-npz`` and ``preprocess_tvsd`` and each
     held equal to its fixture's pickle; then e2e's eval on the rebuilt
     NSD pickle (rows equal to e2e's bit for bit, one launch per RDM).
 11b. parallel — ``parallel/`` on NCCL at world size 1 (a FileStore in the
     temporary directory): the ring ``rdm_sharded`` at (8,192, 4,096) f32
     against the kernel (``tolerance(4096)``; both timed by CUDA events),
     the sharded bootstrap route equal to the unsharded one, one
     data-parallel CustomCNN step against the plain step, and e2e's eval
     with a one-rank mesh and ``rdm_shard_threshold`` 512 (its phase-2
     RDMs on the ring: S·(T + R) + P launches, e2e's layers, scores within
     1e-4 of e2e's).
 12. ref_ckpt — a CustomCNN checkpoint in the reference's own format (a
     torch zip file holding the whole pickled module, 64 classes, epoch
     20) through ``train.checkpoint.load_checkpoint`` on the card and on
     the CPU: its config, and logits within 1e-4 of the largest against
     each other and against the pickled module's own forward; then the
     e2e eval of it (``load_model_from=checkpoint``, cfg_id 64, epoch 20).
 13. e2e_resnet50, e2e_vit — the e2e eval of ResNet50 and ViT-B/16
     (VGG16's runs at 37,000 stimuli in 13f) with
     ``pretrained_dataset=imagenet1k``: a seeded
     state dict in torchvision's layout, written under torchvision's file
     name into a temporary TORCH_WEIGHTS_DIR, is imported (the loaded
     model's first layer, a middle one and its head must equal the
     file's: no random-init fallback). 18 and 14 selection taps (VGG16:
     30, at batch 128: its 30 f32 taps at 256 would not fit beside its
     50 GB of SRP matrices). Rows carry cfg_id 'pretrained' and epoch −1.
     Each also prints the SRP matrices' size, the tap floats per image,
     the peak memory of extraction and of phase 2 with the exact layers'
     widths, bytes and passes.
     Each eval phase prints its wall and phase times, extraction images/s
     with the loader's wait, the stimuli its loaders served by decode
     route, peak device memory, fixture seconds and the RDM shapes it
     asked for; the checks of e2e hold for each (results,
     rows, finite scores, S·(T + R) + U + P launches for T taps).
 13a. kendall — the e2e eval with compare_method=kendall (Kendall
     selection in one batched tau-a call per subject, the per-pair
     route's batched point scores and block-contraction bootstraps),
     with e2e's checks and rows with compare_method kendall; then on the
     first pair's RDMs ``bootstrap_kendall_fast`` against
     ``kendall_tau_a`` of each gathered sub-triangle (first 20 index
     sets, 1e-6), the eval's own scores (1e-6) and the CPU (1e-5); prints
     the selection, point-score and bootstrap seconds.
 13b. dense_boot — the e2e eval with bootstrap_exact_ties=false
     (per-pair dense-rank Spearman bootstraps): e2e's layers, point
     scores within 1e-6 of e2e's, and bootstrap scores within 1e-6 of
     the grouped average-tie path's on tie-free (tie-broken) copies of
     the same RDMs; the fixture's own triangles hold many exact ties,
     and the dense-vs-average-tie difference on them is printed.
 13c. pca — the e2e eval with reconstruct_from_pcs=true pca_k=1: e2e's
     layers, the seconds of each PCA fit, and at the widest exact tap
     ``fit_pca``'s rank-1 reconstruction (an f64 eigh of the n × n Gram)
     against an f64 SVD's (1e-5 of the largest value), with the f32
     SVD's beside it and the seconds of all three; then the planted
     encoding subject (Woodbury shape) with reconstruct_pca_k=16, card
     against CPU at highest on the alphas ≥ 1 (1e-4, same layers).
     The launch checks of e2e hold for all three (S·(T + R) + U + P).
 13d. cross_model — the JAX bench's stage_cross_model through
     ``analysis/cross_model_rdms.run``: AlexNet, ViT-B/16 and the CLIP and
     DINOv2 ViT-L/14 towers (1024 wide, 24 blocks, 16 heads, patch 14)
     from seeded random weights (printed as such: no tower weights are in
     the repository), every layer's RDM over 256 synthetic images (batch
     64, SRP k=4096) and the Spearman matrix of every model pair. First
     each tower at full width: its parameter count equal to the JAX
     tower's and a 2-image forward on the card against the CPU (every tap
     within 1e-4 of its largest |value|), with the card's ms per image of
     an all-taps forward at batch 64. Checks no model error, 7 + 14 + 26 +
     26 = 73 layer RDMs with one kernel launch each, 10 finite matrices and
     every self-pair's diagonal within 1e-6 of 1; prints the wall, each
     model's seconds, the peak memory and the best layer pair of each
     matrix.
 13e. analyses — ``analysis/extract_representations``' CLI on the train
     phase's 1,600 JPEGs (AlexNet; conv5, fc1, fc2) with SRP k=4096,
     ``--spatial-pool`` and exact taps: the SRP rows equal the SRP of the
     exact taps and the pooled rows their H × W means (1e-5 of the largest
     value); ``compute_eigenspectra`` on the SRP file against an f64 SVD
     (1e-5); Two-NN IDs of conv5_post and fc1_post (1e-4 relative) and a
     PLSSVD cross-decomposition against a planted response (1e-4), each
     card against CPU.
 13f. nsd73k_vgg16 — the NSD fixture of 8 subjects × 512 voxels cut to 2
     regions and to 4,500 unique stimuli a subject (37,000 stimuli =
     1,000 shared + 8 × 4,500 unique, against NSD's 73,000, to keep the
     script inside its limit: the fewest that keep VGG16's store over the
     retention budget; a 7.3 GB uint8 brick), and VGG16's eval on it as in
     13 (8 subjects × 2 regions, batch 128) with ``acts_retain`` at auto:
     the rule must retain (the plan's 8,000 rows into the bf16 device
     store, against 9.09 GB unretained), with 13's
     checks (16 results and rows, one launch per RDM) and a peak under
     80 GB. Phase 2 extracts its selected layers in as many passes as
     the card's free memory needs (``evals._exact_groups``).
 13g. nsd73k_encoding — untrained ResNet50's encoding eval (18 taps,
     1000 bootstraps) on the same brick, its first subject × 2 regions
     (5,500 stimuli; the depth cut: selection over all 8 took 99.58 s),
     with ``acts_store=host``: the f32 host store (1.6 GB; ``auto`` takes
     it above 63,711 rows, as at NSD's 73,000), its rows gathered to the
     card from pinned memory; 2 results and
     rows, finite scores and CIs, no RDM launch. Prints the host store's
     GB, the host's resident memory before and its peak after (the
     brick's mapped pages count), the encoding phases and the wall. The
     brick is removed after it.
 14. path (run after 15j) — the RDM shapes every RSA eval, cross_model,
     curriculum_nsd_rsa, the reconstruction sweeps and binary-PC RSA
     called, with
     their launch counts and the kernel's time at each: its time on the
     main path, Σ launches × ms. A shape the kernel phase did not check
     gets the kernel phase's checks here before it is timed, beside the
     plain version's and torch.corrcoef's times.
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
 15'. encoding_sharded — the encoding phase's first subject (9,000 train
     and 1,000 test rows, 2 regions × 7,604 voxels, 14 taps) again,
     through ``compute_encoding_scores_subjects(..., mesh=)`` on a one-rank
     NCCL group (a FileStore in the temp directory): the row-sharded
     route's all-reduces, row gathers and broadcasts run on the card at
     world size 1 (the eval itself takes that route only at two ranks or
     more). Its layers, scores, CIs and selection scores must equal the
     encoding phase's within 1e-4, every ridge tensor lie on the card, every
     collective run and no RDM launch. Prints the sub-phase seconds,
     peak memory, the collective calls and the largest differences.
 16. encoding_check — one subject's ``compute_encoding_scores_subject``
     on planted data (y = tap3·W + noise; 3 taps, 2 regions × 400
     voxels, 1,000 test rows) on both solver routes: n_train 3,200 and
     d 512 (Woodbury; 6,400 before the depth cut), n_train 400 and d 512
     (per-fold eigh, on the
     alphas ≥ 1, where its rank-deficient fold Grams do not decide the
     result by roundoff; the protocol's 20 alphas are run too and their
     card-vs-CPU difference printed). At ``highest`` the card and the CPU
     select the same layers and agree within 1e-4 (scores and CIs); on
     the card ``high`` selects the layers ``highest`` does, with
     |Δscore| ≤ 1e-3.
 16a. encoding_delta — the JAX package's stage_encoding_delta on the
     card: one subject (9,000 / 1,000 stimuli, 4 taps of d 4096 — the
     stage's 14 cut to 4 —, 6 regions of 5,000, 7,604, 2,000, 2,000, 1,500 and 900 voxels) at
     encoding_cv_precision high and highest, without bootstrap; prints
     the layers each selects, the largest score difference and both
     times.
 15a. coarsegrain — the PCA-label pipeline through its CLIs at full
     width (``visreps_tpu_torch/scripts/``): a synthetic ImageNet of
     10,240 256 px JPEGs over 32 classes; AlexNet ``fc2_post`` (10,240 ×
     4096 f32) with seeded IMAGENET1K-layout weights, card against the
     CPU on the first 8 images; the top-20 PCs on the card against an f64
     CPU fit of the same .npz (eigenvalues within 1e-4 relative, largest
     principal angle within 1e-2 rad); labels for 2–64 classes, nested
     (the n-bit label shifted right by one is the (n−1)-bit one), each
     bit above its median for exactly half the images, and card = CPU
     except rows within the card-vs-CPU roundoff of a median (counted);
     CustomCNN trained on the 64-class CSV through ``run.main`` (20 steps
     at batch 256, finite losses, epoch 0 and 1 checkpoints) and that
     checkpoint's NSD RSA eval with e2e's checks (cfg_id 64, epoch 1);
     ViT-B (``--backend flax``, seeded file), CLIP-L/14 and DINOv2-L/14
     (seeded init) over 1,024 images, each card against CPU on the first
     4 within MODEL_TOL. Prints each step's seconds, images/s, peak memory
     and the eval's launches.
 15b. cg_benefits — the coarse-grain-benefit CLIs
     (``visreps_tpu_torch/experiments/coarse_grain_benefits/``) on that
     checkpoint: linear probe, few-shot (1 and 5 shots, 20 episodes),
     class selectivity and augmentation invariance on a seeded
     Tiny-ImageNet tree (100 classes × (20 + 10) at 64 px); ImageNet-C
     robustness (15 corruptions at severity 3, 1,000 images at 224 px,
     the torch L-BFGS logistic probe), with the 6 deterministic
     corruptions card against CPU within 1e-3 on the 0–255 scale and each
     corruption's ms on 64 images; curriculum fine-tuning 64 → 1000
     (late_layers, 2 steps at batch 384 on the coarsegrain phase's
     1,024-image tree); curriculum NSD RSA of the
     64-way, the fine-tuned and the untrained (epoch 0) checkpoints × e2e's
     2 subjects × 2 regions × 7 layers: 84 finite rows and one RDM launch
     per RDM (96). Few-shot and ImageNet-C clean accuracy must beat
     chance; the linear probe is held to finite (its contiguous CV folds
     of class-sorted rows pick the largest alpha, in both packages).
 15c. reconstruction — the PC-reconstruction sweep through
     ``experiments/reconstruction_analysis/run_reconstruction``'s CLI: a
     1000-way CustomCNN trained here (5 steps on the train phase's JPEGs,
     so its rows carry cfg_id 1000 as the sweep and its figure expect) and
     its NSD RSA eval (e2e's checks: the baseline rows); then the sweep on
     e2e's fixture (2 × 2 pairs, pca_k 1–15, full width, 1000 bootstraps,
     Spearman) and on TVSD's fixture and a THINGS fixture of 5 images a
     concept (9,270 ids; the things phase decodes the bench's 25,956) at
     pca_k 1, 2, 4, 8 and 15 (the depth cuts; uint8 feed, so that THINGS'
     decoded ids fit the decode cache and are decoded once), whose
     baseline rows the phase writes into a results.db of their own (an
     eval of their 22,348 or 9,270 images would take ≈ 30 s each; fixed
     layers, listed in RECON). Checks one row
     per (region, subject, pca_k) with the baseline's layer, finite scores
     and CIs, 1000 bootstraps a row, one RDM launch per RDM (neural + ks ·
     unique layers), and the narrowest NSD layer's reconstructions at
     pca_k 1 and 15 against an f64 SVD of the same card taps on the CPU
     (1e-5 of the largest value).
 15d. binary_pc_rsa — ``experiments/binary_pc_rsa/main``'s CLI on the
     coarsegrain phase's eigenvectors with seeded AlexNet (``--pretrained
     none``) on e2e's subjects: n_pcs 2–20, Spearman and Kendall, 304
     finite rows; each Hamming RDM of the first subject at 2 and 20 PCs
     bit-equal to a CPU XOR sum of the same codes, each neural RDM within
     1e-5 of the plain version on the same rows, and one RDM launch per
     neural RDM (the Hamming RDMs are one product each, no kernel).
 15e. figures — fig. 1 from four RSM npz files of the NSD sweep's card
     RDMs (pca_k 1 and 2, 8 and 15) on the card, its Kendall scores within
     1e-6 of the CPU's on the first layer; a long CSV exported from this
     run's results.db (and the TVSD / THINGS sweep rows) read by figs. 2–4
     and the bar plots, module 2 on results.db, the binary-PC figure on
     its CSV, plot_curriculum_rsa on curriculum RSA's rows: each CLI's
     series equal to the same data functions called in this process, and
     module 2's NSD curve, fig. 2's and fig. 3's matrices and both bar
     plots' condition scores to a plain recomputation from results.db
     (SQL rows averaged in Python; 1e-12 relative). The binary-PC and
     curriculum series and figs. 3–4's layer lines are held to the JAX
     package's by the CPU tests only. Prints the figures not drawn
     (no matplotlib here).
 15f. representation — experiments/representation_analysis through its
     CLIs on the train phase's 1,600 JPEGs: dimensionality of the 32-way
     and the runners' 4-way checkpoints (14 taps, SRP k = 4096), every
     metric and the CSV within 1e-4 of a CPU recomputation from the same
     taps on 4 of them (conv1, conv5, fc1, fc2 post; Two-NN 2e-2: its
     Gram-formula distances cancel); variance_ratio,
     nearest_neighbors (top-k equal to the CPU's up to swaps of cosines
     within 1e-6),
     two_pcs_compare (fc2's PCs within 1e-4 up to sign) and run_all on
     those taps; task_brain_alignment on e2e's first subject (the CLI's
     encoding r within 1e-4 of the brain ridge called on the card, its
     alignment within 1e-3 of the CPU's Fisher weights and alignment from
     that ridge's weights; the median alpha reported: roundoff picks
     alphas on flat CV curves); rsm_comparison of untrained
     AlexNet and ResNet18, one RDM launch per tap (24 at (1,600, d)).
 15g. semantic — semantic_alignment's eval of untrained AlexNet on e2e's
     first subject against a seeded stand-in caption-embedding npz (d_emb
     3,072), with and without reconstruct_from_pcs, into a fresh
     results.db: one RDM launch per tap plus one for the embeddings, the
     rows, and scores within 1e-5 of the CPU's (every 4th tap and one
     reconstruction row recomputed there); pc_semantic_analysis
     through --ancestors-csv; fine_grained_structure and
     plot_semantic_classes_umap write their data (embedded and drawn only
     where matplotlib and umap or sklearn import).
 15h. wordnet — the WordNet label source through its CLIs on the
     coarsegrain phase's 10,240-JPEG tree: a 1,000-wnid folder_labels.json
     whose first 32 entries are the tree's folders (via
     IMAGENET_LOCAL_DIR), a seeded synthetic hypernym snapshot for every
     wnid (paths 7–12 deep, a fifth of the wnids with two paths of
     different lengths, every shortest path's Level-6 synset in
     SUPER_CATEGORIES) through WORDNET_PATHS_JSON; ``make_wordnet_labels``'
     7 depth CSVs and ``make_semantic_labels``' CSV each equal line for line
     to a plain recomputation from the snapshot; CustomCNN trained through
     ``run.main`` on the depth with 16 classes (``pca_labels_folder=
     wordnet``, 10 steps at batch 256, full width, finite losses) and that
     checkpoint's NSD RSA eval with e2e's checks (one launch per RDM, its
     rows carrying the folder).
 15i. pca_analysis — ``pca_poles_images`` on the card on the coarsegrain
     phase's AlexNet fc2 features (10,240 × 4,096) and on a seeded 110,000
     × 4,096 f32 matrix with a planted spectrum (the JAX script's n_fit),
     each against an f64 fit on the card: the top 6 eigenvalues within
     1e-4 relative, the largest principal angle printed, and for every
     PC ≥ 1e-2 (relative) from its neighbours' eigenvalues the scores
     within 1e-4 of its largest |score| up to sign and the CLI's poles up
     to sign and near ties; the fit's, Gram's and eigh's seconds.
     ``pca_visualization`` (sampled scores equal to a plain recomputation
     bit for bit), ``visualize_class_distribution`` on the 64-class CSV
     and each WordNet CSV (equal to a plain count), the fig. 1a
     schematic's data; no figure drawn here.
 15j. plotters — the four ``plot_coarseness`` CLIs (NSD with both region
     presets and with the encoding score, NSD-Synthetic, THINGS, TVSD)
     and ``plot_architectures`` on a seeded results.db in
     tests/test_plotters.py's layout (written through the port's
     ``save_results``) and on this run's results.db: every JSON series
     equal to a plain sqlite3 + numpy recomputation within 1e-12 relative
     (keys, labels, x positions and NaN places exact); ``plotter_utils``'
     query and summary of the WordNet checkpoint's rows the same way.
 17. kernels — the per-kernel summary line (launches: the nineteen RSA
     evals run in this process, cross_model, curriculum_nsd_rsa, the
     reconstruction sweeps, binary-PC RSA's neural RDMs, rsm_comparison
     and semantic_alignment; the procs workers' launches are theirs; the
     encoding evals, the analyses, the PCA pipelines, training and the
     figures launch none).

Then the card's name and power limit, and the final status line.
Needs CUDA; exits 1 without it.
"""
from __future__ import annotations

import csv
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
from contextlib import contextmanager
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
# (the Woodbury route at 3,200 train rows: 6,400 took 13.5 s on the CPU side)
ENC_CHECK = {"routes": {"woodbury": (3200, 512), "eigh": (400, 512)},
             "taps": 3, "voxels": 400, "n_test": 1000, "n_bootstrap": 1000}
ENC_TOL = 1e-4       # card vs CPU at "highest": scores and CIs
ENC_HIGH_TOL = 1e-3  # "high" vs "highest" on the card: |Δscore|
TF32_PEAK_OPS = 495e12
TRAIN = {"n_images": 1600, "batch": 256, "epochs": 2, "pca_n_classes": 32}
STEP = {"batch": 256, "iters": 8, "classes": 1000, "parity_batch": 8}
STEP_RTOL = 1e-4  # card vs CPU: cuDNN and the CPU sum in different orders
# train_families: the train step of each family at STEP's batch and
# classes, in f32 and in the JAX package's bf16 compute; each family's
# f32 step at batch 8 without dropout, card against CPU, within STEP_RTOL.
FAMILY_STEP = {"families": ["VGG16", "ResNet18", "ResNet50", "ViTBase", "ECTiedNet"],
               "dtypes": ["float32", "bfloat16"], "iters": 5}
# train_resume: ResNet18 on the train phase's JPEGs (PCA labels at one of
# the runners' granularities, so its results.db rows are its own).
RESUME = {"model": "ResNet18", "pca_n_classes": 4, "taps": 10}
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
    "VGG16": {"phase": "nsd73k_vgg16", "taps": 30, "batch": 128, "seed": 13, "probes": [
        ("conv1.weight", "features.0.weight"),
        ("conv8.weight", "features.17.weight"),
        ("fc3.weight", "classifier.6.weight")]},
}
REF_CKPT = {"classes": 64, "epoch": 20, "seed": 14}
# decode: images of THINGS' pool per timed pass, at THINGS' batch and
# num_workers; the C++ decoder against the port's PIL transform on the
# first ``check`` of them within tests/test_native_decode.py's bounds
# (normalised: mean and max |Δ|; uint8: mean and max gray levels).
DECODE = {"n_images": 2048, "batch": 512, "workers": 16, "check": 64}
NATIVE_TOL = {"mean": 0.02, "max": 0.15, "u8_mean": 2.0, "u8_max": 40}
# trace: the trainer in train_step's configuration (CustomCNN, 1000
# classes, batch 256, AdamW) on the train phase's images: 2 epochs × 5
# steps, no evaluation, no checkpoint.
TRACE_TRAIN = {"epochs": 2, "steps": 10}
# runners: train_runner over seed 1 × pca_n_classes, 1 epoch each, on the
# train phase's images; then eval_runner over those checkpoints (the e2e
# eval's configuration, eval_checkpoint_at_epoch 1). One combo (the depth
# cut; two took 66 s): the representation phase reads its 4-way checkpoint,
# and tests/test_torch_port_runners.py holds the loop over combos.
RUNNERS = {"pca_n_classes": [4], "epochs": 1}
# kendall: bootstrap_kendall_fast against kendall_tau_a of each gathered
# sub-triangle (both exact integer counts: equal up to the f32 rounding of
# the tau) and against the same function on the CPU.
KENDALL_CHECK = {"iters": 20, "tol": 1e-6, "cpu_tol": 1e-5}
# dense_boot: average-tie point scores grouped (e2e) and batched (the
# per-pair route), and dense against average-tie ranks on tie-free
# triangles: the same statistic, f32 sums in other orders.
DENSE_TOL = 1e-6
# pca: the eval's pca_k; fit_pca's rank-1 reconstruction (f64 Gram eigh,
# f32 out) against the same from an f64 SVD (max |Δ| / max |value|: the
# f32 rounding of the mean, components and products); the planted
# encoding subject's reconstruct_pca_k.
PCA_K = 1
PCA_TOL = 1e-5
ENC_PCA_K = 16
# encoding_delta: visreps_tpu/benchmarks/stages.py:296 stage_encoding_delta's shape.
# (4 of the stage's 14 taps, the planted tap3 among them: the depth cut; 14
# took 11.3 s at high and 21.1 s at highest)
ENC_DELTA = {"n_train": 9000, "n_test": 1000, "d": 4096, "taps": 4,
             "voxels": (5000, 7604, 2000, 2000, 1500, 900)}
# cross_model: visreps_tpu/benchmarks/stages.py:706 stage_cross_model's defaults,
# from seeded random weights (no tower weights are in the repository): layer
# RDMs per model (return nodes, extract_pre_and_post off) and the card-vs-CPU
# tolerance of one full-width tower forward. TOWER_PARAMS: the JAX towers'
# parameters at 224 px (jax.eval_shape of visreps_tpu/models/hf_vit.py;
# tests/test_torch_port_towers.py holds the port's to them on the CPU).
CROSS_MODEL = {"models": ["AlexNet", "ViTBase", "clip-vit-l14", "dinov2-l14"],
               "n_images": 256, "batch": 64, "srp_k": 4096, "method": "spearman",
               "layers": {"AlexNet": 7, "ViTBase": 14, "clip-vit-l14": 26, "dinov2-l14": 26}}
TOWER_PARAMS = {"clip-vit-l14": 303_966_208, "dinov2-l14": 303_227_904}
CORR_DIAG_TOL = 1e-6  # a self-pair's layer-with-itself Spearman: 1 up to f32 rounding
# analyses: extract_representations' CLI on the train phase's JPEGs (AlexNet,
# its default nodes, batch 128) in its three variants; consistency of the
# variants (SRP of the exact taps, H × W means of the exact conv taps) and
# eigenvalues against an f64 SVD within ``tol`` of the largest value; Two-NN
# IDs and the cross-decomposition score, card against CPU (``id_tol``
# relative, ``xdec_tol`` absolute), on a planted response of ``voxels``
# columns with a rank-``rank`` signal.
ANALYSES = {"nodes": ["conv5", "fc1", "fc2"], "batch": 128, "tol": 1e-5, "id_tol": 1e-4,
            "xdec_tol": 1e-4, "voxels": 500, "rank": 25}
# procs: the e2e eval split over 2 worker processes (``--procs 2``) into a
# fresh results.db; its rows against e2e's (each worker runs e2e's arithmetic
# on its subjects: equal bits expected, a difference up to ``tol`` allowed
# for f32 sums grouped over another set of pairs).
PROCS = {"procs": 2, "tol": 1e-6}
# nsd73k: the NSD fixture (8 subjects, 512 voxels, 256 px) cut to 2 regions and
# to 4,500 unique stimuli a subject (37,000 stimuli, against the default 73,000 =
# 1,000 shared + 8 × 9,000 unique, to keep the script inside its limit). VGG16
# from a seeded file (RSA, acts_retain auto: its 37,000-row bf16 store would be
# 9.09 GB, over the 9e9-byte budget), ResNet50 untrained (encoding, acts_store
# host: the f32 host store that auto takes at NSD's 73,000 stimuli; at 37,000
# auto would take the bf16 device store, 5.23e9 bytes). 37,000 is just above
# the 36,622 stimuli where VGG16's store reaches the budget.
# The encoding eval selects over ``encoding_subjects`` of the 8 (its ridge
# selection, ≈ 12 s a subject, took 99.58 s over all 8): 1,000 shared +
# 4,500 unique stimuli into the f32 host store.
NSD73K = {"n_shared": 1000, "n_unique": 4500, "n_subjects": 8, "n_regions": 2,
          "n_voxels": 512, "img_size": 256, "device_gb": 80, "encoding_subjects": 1}

# coarsegrain: the PCA-label pipeline on a synthetic ImageNet of ``n_images``
# 256 px JPEGs (32 classes): AlexNet fc2_post from a seeded IMAGENET1K-layout
# file, the top_k PCs on the card against an f64 CPU fit of the same features
# (eigenvalues within ``eig_rtol`` relative, the largest principal angle of the
# two top_k subspaces within ``angle_tol`` radians: CPU float32 against float64
# at 2,048 images gave 6.9e-6 and 1.1e-3), ``max_bits`` of labels, CustomCNN
# trained on the 64-class CSV (``train_fraction`` of the train split: 20 steps
# at ``batch``) and its NSD RSA eval; ViT-B (seeded file), CLIP-L/14 and
# DINOv2-L/14 (seeded init) on a second tree of ``tower_images``; each model's
# card features against its CPU forward on the first ``check_rows`` images
# (``tower_check_rows`` for the towers) within MODEL_TOL.
COARSEGRAIN = {"n_images": 10240, "tower_images": 1024, "top_k": 20, "max_bits": 6,
               "batch": 256, "train_fraction": 0.625, "train_steps": 20, "alexnet_seed": 21,
               "vit_seed": 22, "check_rows": 8, "tower_check_rows": 4, "eig_rtol": 1e-4,
               "angle_tol": 1e-2}
# cg_benefits: a seeded Tiny-ImageNet tree (``classes`` × (n_train + n_val) at
# 64 px; 100 of Tiny-ImageNet's 200 classes, the depth cut) for the probes;
# ImageNet-C on ``imc_images`` of its train images at 224 px; the
# deterministic corruptions on ``corrupt_check`` images, card against CPU
# within ``corrupt_tol`` on the 0–255 scale; curriculum fine-tuning 64 → 1000
# (late_layers, 1 epoch at ``finetune_batch``: 2 steps on the coarsegrain
# phase's 1,024-image tower tree, the depth cut — 22 on its 10,240-image
# tree took 19–24 s); curriculum NSD RSA on e2e's subjects.
CG_BENEFITS = {"classes": 100, "n_train": 20, "n_val": 10, "k_shot": [1, 5], "episodes": 20,
               "imc_images": 1000, "corrupt_check": 64, "corrupt_tol": 1e-3,
               "deterministic": ["brightness", "contrast", "pixelate", "defocus_blur",
                                 "zoom_blur", "jpeg_compression"],
               "finetune_batch": 384}
# reconstruction: run_reconstruction's CLI on a 1000-way CustomCNN trained here
# (``train_epochs`` on the train phase's JPEGs, so its rows carry cfg_id 1000
# as the sweep and its figure expect) with its own NSD baseline eval: NSD on
# e2e's fixture at every ``nsd_k``, TVSD and THINGS on their phases' fixtures
# at ``k`` (the depth cut), their baseline rows written into a separate
# results.db (``baselines``: the best layer of each pair; an eval of TVSD's
# 22,348 or THINGS' 25,956 images would take ≈ 30 s each), both with the uint8
# feed (THINGS' float feed, 15.6 GB, would overflow the decode cache and
# decode every image twice). The card's
# reconstructions at ``check_k`` of the narrowest NSD layer against an f64
# SVD of the same taps on the CPU within PCA_TOL.
RECON = {"nsd_k": list(range(1, 16)), "k": [1, 2, 4, 8, 15], "train_epochs": 1,
         "check_k": [1, 15], "tvsd_layers": {"V1": "conv3_post", "V4": "conv5_post",
                                             "IT": "fc1_post"},
         "things_layer": "fc1_post", "fig1_k": {"f1": 1, "f2": 2, "t1": 8, "t2": 15}}
# THINGS' sweep runs on a THINGS fixture of its own at 5 images a concept
# (9,270 ids over 1,024 JPEGs; the things phase decodes the bench's 25,956)
RECON_THINGS = {**THINGS, "imgs_per_concept": 5, "n_jpeg": 1024}
# binary_pc_rsa: its CLI on the coarsegrain phase's eigenvectors, seeded
# AlexNet (``--pretrained none``) on e2e's subjects; every Hamming RDM of the
# first subject at ``check_pcs`` against a CPU XOR sum, bit for bit.
BINARY = {"n_pcs": list(range(2, 21)), "correlations": ["spearman", "kendall"],
          "check_pcs": [2, 20]}
# figures: fig. 1's Kendall scores on the card against the CPU's (first layer)
FIG1_TOL = 1e-6
# representation: the analyses of experiments/representation_analysis on the
# train phase's 1,600 JPEGs. dimensionality compares its 32-way checkpoint
# with the runners' 4-way one (both at epoch 1), all 7 taps pre and post, SRP
# k = 4096, Two-NN on every row; each metric against the CPU's on the same
# taps (eigenvalues of the largest, the others relative). rsm_comparison: the
# JAX script's default models, untrained, every tap. task_brain_alignment:
# fc2 of the 32-way checkpoint on e2e's first subject and region.
REPR = {"batch": 256, "checkpoint": "checkpoint_epoch_1.pth", "cfg_ids": [32, 4],
        "srp_k": 4096, "models": ["AlexNet", "ResNet18"], "layer": "fc2_post", "k": 5,
        "n_queries": 32, "region": "early visual stream",
        # the dimensionality metrics recomputed on the CPU (4 of the 14 taps)
        "cpu_taps": ["conv1_post", "conv5_post", "fc1_post", "fc2_post"]}
REPR_TOL = 1e-4       # card vs CPU: eigenvalues, PR, Hoyer, PCs, encoding r, alignment
# Two-NN (ID and bootstrap SE) card vs CPU: nearest-neighbour distance ratios
# from the Gram formula (the JAX program's), whose cancellation leaves ~1e-7·|x|²
# of roundoff in each squared distance, summed in other orders on each device
# (the 4-way checkpoint's crowded fc taps: ID up to 2.7e-3, bootstrap SE up to
# 6.0e-3; the 32-way's: 1.4e-4 and 3.9e-4; this script on an H100 80GB HBM3,
# 700 W)
TWONN_TOL = 2e-2
# task_brain_alignment's cosine, Spearman and Pearson card vs CPU: mean |w| of a
# rank-deficient ridge fit (1,600 fit rows, 4,096 dims: the per-fold-eigh route,
# where f32 roundoff moves the weights; 7.2e-5 seen on an H100 80GB HBM3, 700 W)
TBA_TOL = 1e-3
NN_TIE_TOL = 1e-6     # nearest neighbours: a swap only between CPU cosines this close
RSM_TOL = 1e-6        # the similarity matrix: symmetric, unit diagonal
# semantic: semantic_alignment on e2e's first subject and region, a seeded
# stand-in caption-embedding npz (d_emb 3,072) over the fixture's ids, with
# and without reconstruct_from_pcs; scores against the CPU's on the same taps
# (every tap without the reconstruction, the first ``recon_check`` with it:
# an f64 eigh of each (2,000, 2,000) Gram takes seconds on the CPU).
SEMANTIC = {"d_emb": 3072, "pca_k": 16, "recon_check": 1, "tap_stride": 4,
            "nodes": ["conv1", "conv2", "conv3", "conv4", "conv5", "fc1", "fc2"], "n_sem": 8}
SEM_TOL = 1e-5        # RSA score, card vs CPU (RDM ties move Spearman ranks ~1e-6)
# wordnet: the WordNet label source on the coarsegrain phase's tree (its 32
# folders first in a ``n_wnids``-wnid folder_labels.json) with a snapshot of
# hypernym paths from ``seed`` (``two_path_share`` of the wnids with two
# paths); CustomCNN trained on the depth whose class count is nearest
# ``target_k``: ``train_fraction`` of the 8,192 train images, ``steps`` steps
# at ``batch``; then that checkpoint's NSD RSA eval.
WORDNET = {"n_wnids": 1000, "seed": 15, "two_path_share": 0.2, "target_k": 16, "batch": 256,
           "train_fraction": 0.3125, "steps": 10}
# pca_analysis: pca_poles_images on a seeded (n_rows, d) f32 matrix with a
# planted spectrum (``spectrum`` then ``floor`` along a random basis; the JAX
# script's full n_fit), and on the coarsegrain features; the top n_pcs against
# an f64 fit on the card: eigenvalues within eig_rtol (relative), scores
# within score_tol of each PC's largest |score| up to sign, for PCs whose
# f64 eigenvalue lies ``gap`` (relative) from its neighbours.
PCA_POLES = {"n_rows": 110_000, "d": 4096, "seed": 16, "n_poles": 100, "n_pcs": 6,
             "spectrum": [12.0, 9.0, 7.0, 5.5, 4.3, 3.4, 2.7], "floor": 0.4,
             "eig_rtol": 1e-4, "score_tol": 1e-4, "gap": 1e-2}
# plotters: tests/test_plotters.py's seeded results.db (subjects per dataset:
# 2 of its 4 for NSD and NSD-Synthetic, as 1,316 runs took 21.2 s to write on
# the card's machine), every series held to a plain sqlite3 + numpy
# recomputation within rtol
PLOTTERS = {"seed": 0, "subjects": {"nsd": 2, "nsd_synthetic": 2, "tvsd": 2}, "rtol": 1e-12}
# parallel/ at world size 1: the ring against the kernel at (n, d) f32; the
# sharded bootstrap at e2e's shapes; one DP train step of CustomCNN at batch
# dp_batch against the plain step;
# e2e's eval with phase 2's RDMs on the ring (threshold below its 1,000 test
# stimuli), scores within score_tol of e2e's (see phase_parallel). dp_tols are
# tests/test_sharding.py's for the JAX package's sharded step
PARALLEL = {"n": 8192, "d": 4096, "seed": 16, "boot_n": 1000, "n_boot": 1000, "dp_batch": 16,
            "dp_tols": {"loss_rtol": 1e-5, "grad_norm_rtol": 1e-3, "param_atol": 3e-3,
                        "stats_atol": 1e-5},
            "threshold": 512, "score_tol": 1e-4}


START = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line also gets ``t_s``, the seconds
    since the script started."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - START}
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
    dtype)), the wall seconds, the eval's phase times, the stimuli its
    loaders served by route (``data/loader.ROUTES``: native, pil, array,
    brick, cache) and the peak device memory (GB)."""
    import torch

    from visreps_tpu_torch import evals, run
    from visreps_tpu_torch.data import loader

    routes = Counter(loader.ROUTES)
    with rdm_probe() as probe:
        t0 = time.perf_counter()
        results = run.main(["--mode", "eval", "--config", str(ROOT / "configs/eval/base.json"),
                            "--override", *overrides])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"results": results, "launches": probe["launches"], "shapes": probe["shapes"],
            "seconds": wall, "phases": dict(evals.LAST_PHASE_TIMES),
            "decode_routes": dict(Counter(loader.ROUTES) - routes),
            "peak_mem_gb": probe["peak_mem_gb"]}


@contextmanager
def rdm_probe():
    """While in use, counts the RDM shapes ``compute_rdm`` hands the kernel
    wrapper (a Counter of (n, d, dtype) under "shapes"); the kernel's
    launch count is set to 0 on entry and read on exit ("launches"), with
    the peak device memory in between ("peak_mem_gb")."""
    import torch

    from visreps_tpu_torch.ops import rdm as rdm_ops
    from visreps_tpu_torch.ops import rdm_kernel

    seen = {"shapes": Counter()}
    wrapper = rdm_ops.rdm_from_centered

    def probe(xc, std, correction=1e-12):
        seen["shapes"][(xc.shape[0], xc.shape[1], str(xc.dtype).removeprefix("torch."))] += 1
        return wrapper(xc, std, correction)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rdm_ops.rdm_from_centered = probe
    try:
        rdm_kernel.LAUNCHES = 0
        yield seen
        torch.cuda.synchronize()
        seen["launches"] = rdm_kernel.LAUNCHES
        seen["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    finally:
        rdm_ops.rdm_from_centered = wrapper


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


def db_bootstraps(where: str) -> list:
    """The stored bootstrap distributions of the results rows ``where``
    selects."""
    with sqlite3.connect(os.environ["VISREPS_RESULTS_DB"]) as conn:
        return [json.loads(s) for (s,) in conn.execute(
            "SELECT scores FROM bootstrap_distributions WHERE (run_id, compare_method) IN "
            f"(SELECT run_id, compare_method FROM results WHERE {where})")]


def eval_record(phase: str, run: dict, n_images: int, fixture_s: float, **extra) -> dict:
    """The line each eval phase prints: wall and phase times, extraction
    images/s and the loader's wait, the decode routes, peak memory,
    fixture seconds, the kernel's launches and the RDM shapes asked for."""
    phases = run["phases"]
    rec = {"phase": phase, "seconds": run["seconds"], "fixture_s": fixture_s,
           "n_images": n_images, "n_results": len(run["results"]),
           "rdm_launches": run["launches"],
           "rdm_shapes": [[*k, v] for k, v in sorted(run["shapes"].items())],
           "decode_routes": run["decode_routes"],
           "phase_times_s": phases, "peak_mem_gb": run["peak_mem_gb"], **extra}
    if "extraction_s" in phases:
        rec["images_per_s"] = n_images / phases["extraction_s"]
        rec["loader_wait_s"] = phases["extraction_loader_s"]
    rec["scores"] = [{"layer": r["layer"], "score": r["score"], "ci": [r["ci_low"], r["ci_high"]]}
                     for r in run["results"]]
    emit(rec)
    return rec


def rsa_overrides(source: list[str], subjects: list, regions: list, batch: int = 256,
                  options: tuple = ()) -> list[str]:
    """The NSD RSA eval's overrides (the e2e configuration) for a model
    ``source``; ``options`` are applied last."""
    return [
        *source, "neural_dataset=nsd", "analysis=rsa", "compare_method=spearman",
        f"subject_idx={json.dumps(subjects)}", f"region={json.dumps(regions)}",
        "bootstrap=true", "n_bootstrap=1000", "n_select=1000", "srp_k=4096",
        "extract_pre_and_post=true", "uint8_transfer=true", "log_expdata=true",
        f"batchsize={batch}", "num_workers=8", *options,
    ]


def run_eval(phase: str, meta: dict, source: list[str], db_where: str, expect_row,
             n_taps: int = 14, batch: int = 256, extra: dict | None = None,
             options: tuple = (), subjects: list | None = None, regions: list | None = None):
    """The NSD RSA eval on the fixture (``drive``); checks results, db rows
    (``db_where`` selects this eval's; ``expect_row`` checks each row's
    (cfg_id, epoch)), ``n_taps`` selection scores per result, finite
    scores and one launch per RDM. ``options`` are overrides applied last
    (another compare_method, bootstrap_exact_ties, reconstruct_from_pcs).
    ``extra`` (filled while the eval runs) joins the printed line.
    ``subjects`` and ``regions`` default to E2E's.
    Returns the run (``drive``'s dict)."""
    subjects = list(range(E2E["n_subjects"])) if subjects is None else subjects
    regions = NSD_REGIONS[: E2E["n_regions"]] if regions is None else regions
    run = drive(rsa_overrides(source, subjects, regions, batch, options))
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


def phase_pretrained(meta: dict, tmp: Path, name: str, phase: str | None = None,
                     subjects: list | None = None, regions: list | None = None,
                     extra: dict | None = None) -> dict:
    """The e2e eval of ``name`` with ``pretrained_dataset=imagenet1k``,
    its weights from a seeded torchvision-layout file; checks that the
    import took the file's values, and records the memory of the
    extraction and of phase 2. ``phase``, ``subjects`` and ``regions``
    default to the spec's phase and E2E's pairs; ``extra`` joins the
    printed line."""
    import torch

    from visreps_tpu_torch import evals
    from visreps_tpu_torch.benchmarks.weights import write_torchvision_weights
    from visreps_tpu_torch.models.extractor import FeatureExtractor

    spec = PRETRAINED[name]
    t0 = time.perf_counter()
    path = write_torchvision_weights(tmp / "torch_weights", name, seed=spec["seed"])
    extra = {"model": name, "weight_file": path.name, "weight_file_mb": path.stat().st_size / 1e6,
             "weight_file_s": time.perf_counter() - t0, **(extra or {})}
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
        """Phase 2's passes (one per group of layers): the extraction's peak
        at the first, then the layers, GB and passes summed over all."""
        if "extraction_peak_gb" not in extra:
            dims = set(self.tap_dims.values())
            extra.update({
                "tap_floats_per_image": sum(self.tap_dims.values()),
                "srp_matrices_gb": sum(2 * d * self.srp.out_dim(d) for d in dims) / 1e9,
                "extraction_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "exact_layers": {}, "exact_gb": 0.0, "centred_copy_gb": 0.0,
                "phase2_passes": 0})
            torch.cuda.reset_peak_memory_stats()
        gb = {l: 4 * len(loader.dataset) * self.tap_dims[l] / 1e9 for l in layer_names}
        extra["exact_layers"].update({l: self.tap_dims[l] for l in layer_names})
        extra["exact_gb"] += sum(gb.values())
        extra["centred_copy_gb"] = max(extra["centred_copy_gb"], *gb.values())
        extra["phase2_passes"] += 1
        return exact(self, loader, layer_names, stimulus_ids)

    evals.load_model, FeatureExtractor.extract_layers_exact = load, exact_probe
    try:
        run = run_eval(phase or spec["phase"], meta, [
            "load_model_from=torchvision", f"model_name={name}", "pretrained_dataset=imagenet1k"],
            f"cfg_id = 'pretrained' AND model_name = '{name}'",
            lambda cfg_id, epoch: cfg_id == "pretrained" and epoch == -1,
            n_taps=spec["taps"], batch=spec["batch"], extra=extra, subjects=subjects,
            regions=regions)
    finally:
        evals.load_model, FeatureExtractor.extract_layers_exact = load_model, exact
        del os.environ["TORCH_WEIGHTS_DIR"]
    return run


RSA_OVERRIDES = ["load_model_from=torchvision", "model_name=AlexNet", "pretrained_dataset=none",
                 "analysis=rsa", "compare_method=spearman", "bootstrap=true",
                 "n_bootstrap=1000", "srp_k=4096", "extract_pre_and_post=true",
                 "log_expdata=true", "num_workers=16"]


def host_peak_rss_gb() -> float:
    """This process's peak resident host memory so far (GB)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9



def host_rss_gb() -> float:
    """This process's resident host memory now (GB)."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


@contextmanager
def store_probe():
    """While in use, records the SRP store of each ``get_activations`` call:
    its kind, whether rows were retained, the rows kept of the stimuli,
    its GB, dtype and device, and the bf16 store of every stimulus (the
    estimate the store rule reads)."""
    from visreps_tpu_torch.models.extractor import FeatureExtractor

    own = FeatureExtractor.get_activations
    seen = {}

    def probe(self, loader, store="device", retain_ids=None):
        acts, ids = own(self, loader, store=store, retain_ids=retain_ids)
        first = next(iter(acts.values()))
        n = len(loader.dataset)
        seen.update(store=store, retained=retain_ids is not None, rows=len(ids), n_stimuli=n,
                    store_gb=sum(a.numel() * a.element_size() for a in acts.values()) / 1e9,
                    dtype=str(first.dtype).removeprefix("torch."), device=first.device.type,
                    out_dims_total=sum(self.out_dims().values()),
                    full_bf16_store_gb=2 * n * sum(self.out_dims().values()) / 1e9)
        return acts, ids

    FeatureExtractor.get_activations = probe
    try:
        yield seen
    finally:
        FeatureExtractor.get_activations = own


def phase_retain(meta: dict, e2e_run: dict) -> dict:
    """The e2e eval with ``acts_retain=true``: only the phase-1 plan's rows
    are kept (2 × 1,000 of 3,000). Its results must equal e2e's bit for
    bit (layers, selection scores, scores, CIs, bootstrap arrays); with
    e2e's checks."""
    with store_probe() as store:
        run = run_eval("retain", meta, E2E_SOURCE, "cfg_id = 'untrained'", untrained,
                       options=("acts_retain=true",), extra={"store": store})
    differing = [i for i, (r, e) in enumerate(zip(run["results"], e2e_run["results"]))
                 if r != e]
    rec = {"phase": "retain_check", "retained_rows": store["rows"],
           "n_stimuli": store["n_stimuli"], "store_gb": store["store_gb"],
           "unretained_store_gb": store["full_bf16_store_gb"], "peak_mem_gb": run["peak_mem_gb"],
           "rdm_launches": run["launches"], "bit_equal_to_e2e": not differing,
           "differing_results": differing}
    emit(rec)
    if not store["retained"] or store["store"] != "device" or store["rows"] >= store["n_stimuli"]:
        raise RuntimeError(f"retain: acts_retain=true kept {store}")
    if differing or len(run["results"]) != len(e2e_run["results"]):
        raise RuntimeError(f"retain: results {differing} differ from e2e's")
    return run


def phase_procs(meta: dict, e2e_run: dict, tmp: Path) -> dict:
    """``run.main(["--mode", "eval", "--procs", "2", ...])`` in e2e's
    configuration: one worker process per subject on the card, both
    writing a fresh results.db (WAL). The rows are read back through
    ``explore_results``: every (subject, region) present, and e2e's layers
    and scores (CIs and bootstrap arrays too) within PROCS["tol"]; prints
    the wall, each worker's exit code and the largest difference. The
    workers' RDM launches are theirs, not counted here."""
    import types

    import torch

    from visreps_tpu_torch import explore_results, run

    subjects, regions = list(range(E2E["n_subjects"])), NSD_REGIONS[: E2E["n_regions"]]
    db = tmp / "procs.db"
    argv = ["--mode", "eval", "--procs", str(PROCS["procs"]),
            "--config", str(ROOT / "configs/eval/base.json"),
            "--override", *rsa_overrides(E2E_SOURCE, subjects, regions)]
    workers = []

    def popen(*args, **kwargs):
        workers.append(subprocess.Popen(*args, **kwargs))
        return workers[-1]

    saved = {k: os.environ.get(k) for k in ("VISREPS_RESULTS_DB", "PYTHONPATH")}
    os.environ["VISREPS_RESULTS_DB"] = str(db)
    os.environ["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT), saved["PYTHONPATH"]]))
    run.subprocess = types.SimpleNamespace(Popen=popen)
    torch.cuda.empty_cache()  # the workers share the card
    try:
        t0 = time.perf_counter()
        rc = _cli_exit(run.main, argv)
        wall = time.perf_counter() - t0
    finally:
        run.subprocess = subprocess
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    rows = explore_results.run_sql(
        "SELECT r.region, r.subject_idx, r.layer, r.score, r.ci_low, r.ci_high, b.scores "
        "FROM results r JOIN bootstrap_distributions b "
        "ON r.run_id = b.run_id AND r.compare_method = b.compare_method", db)
    matrix = explore_results.completeness("nsd", "rsa", db)
    missing = [(s, r) for r in regions for s in subjects
               if not any(m["region"] == r and m["subject"] == str(s) and m["seed1"] == "x"
                          for m in matrix)]
    want = {(r, str(s)): res for (r, s), res in zip(
        [(r, s) for r in regions for s in subjects], e2e_run["results"])}
    layers_differ, diffs = [], [0.0]
    for row in rows:
        ref = want.get((row["region"], row["subject_idx"]))
        if ref is None or ref["layer"] != row["layer"]:
            layers_differ.append([row["region"], row["subject_idx"], row["layer"]])
            continue
        got = [row["score"], row["ci_low"], row["ci_high"], *json.loads(row["scores"])]
        diffs.extend(abs(a - b) for a, b in zip(
            got, [ref["score"], ref["ci_low"], ref["ci_high"], *ref["bootstrap_scores"]]))
    rec = {"phase": "procs", "procs": PROCS["procs"], "seconds": wall, "rc": rc,
           "worker_rcs": [w.returncode for w in workers], "db_rows": len(rows),
           "missing_pairs": missing, "layers_differ": layers_differ,
           "max_abs_diff_vs_e2e": max(diffs), "bit_equal_to_e2e": max(diffs) == 0.0,
           "tol": PROCS["tol"], "summary": explore_results.summary(db)}
    emit(rec)
    if rc or len(workers) != PROCS["procs"] or any(w.returncode for w in workers):
        raise RuntimeError(f"procs: exit code {rc}, workers {rec['worker_rcs']}")
    if missing or layers_differ or len(rows) != len(want) or not max(diffs) <= PROCS["tol"]:
        raise RuntimeError(f"procs: the sharded rows are not e2e's: {rec}")
    return rec


def nsd73k_fixture(tmp: Path) -> dict:
    """The NSD fixture at NSD73K's scale under ``tmp`` (``df`` first); points
    the NSD loaders at it and returns its meta with the seconds."""
    from visreps_tpu_torch.benchmarks import fixture

    root = tmp / "nsd73k_fixture"
    root.mkdir()
    df = subprocess.run(["df", "-k", str(root)], capture_output=True, text=True, check=True)
    free_gb = shutil.disk_usage(root).free / 1e9
    spec = {k: NSD73K[k] for k in ("n_shared", "n_unique", "n_subjects", "n_regions",
                                   "n_voxels", "img_size")}
    t0 = time.perf_counter()
    meta = fixture.ensure_fixture(root, **spec)
    meta["fixture_s"] = time.perf_counter() - t0
    os.environ["NSD_DATA_DIR"] = str(Path(meta["pickle"]).parent)
    os.environ["NSD_STIMULI_HDF5"] = meta["stimuli"]
    emit({"phase": "nsd73k_fixture", "df": df.stdout.strip().splitlines()[-1],
          "free_gb": free_gb, "n_unique": spec["n_unique"], "n_stimuli": meta["n_stimuli"],
          "brick_gb": Path(meta["stimuli"]).stat().st_size / 1e9, "seconds": meta["fixture_s"]})
    return meta


def phase_nsd73k_vgg16(meta: dict, tmp: Path) -> dict:
    """VGG16 (seeded torchvision-layout file, ``phase_pretrained``'s
    checks) on the 37,000-stimulus fixture, 8 subjects × 2 regions, with
    ``acts_retain`` at auto: the rule must retain (the plan's ≈ 8,000
    rows) into the device store; 16 results and rows, finite scores, 1000
    bootstraps, one launch per RDM, and a peak under the card's 80 GB."""
    subjects = list(range(NSD73K["n_subjects"]))
    regions = NSD_REGIONS[: NSD73K["n_regions"]]
    with store_probe() as store:
        run = phase_pretrained(meta, tmp, "VGG16", subjects=subjects, regions=regions,
                               extra={"store": store})
    rec = {"phase": "nsd73k_vgg16_check", "retained": store["retained"],
           "retained_rows": store["rows"], "n_stimuli": store["n_stimuli"],
           "store": store["store"], "store_gb": store["store_gb"],
           "unretained_store_gb": store["full_bf16_store_gb"], "peak_mem_gb": run["peak_mem_gb"],
           "device_gb": NSD73K["device_gb"], "rdm_launches": run["launches"]}
    emit(rec)
    if not store["retained"] or store["store"] != "device" or store["dtype"] != "bfloat16":
        raise RuntimeError(f"nsd73k_vgg16: acts_retain=auto did not retain into the device "
                           f"store: {store}")
    if not run["peak_mem_gb"] < NSD73K["device_gb"]:
        raise RuntimeError(f"nsd73k_vgg16 peaked at {run['peak_mem_gb']} GB")
    return run


def phase_nsd73k_encoding(meta: dict) -> None:
    """The encoding eval of untrained ResNet50 (18 taps) on the
    37,000-stimulus fixture, its first NSD73K["encoding_subjects"] subject
    × 2 regions (5,500 stimuli), ``acts_store=host``: the f32 host store,
    as ``auto`` takes it at NSD's 73,000 stimuli (the rule's choice at
    every size is tests/test_torch_port_retention.py's); 2 results and
    rows, 18
    selection scores and 1000 bootstraps each, finite scores and CIs, no
    RDM launch. Prints the host store's GB, the host's resident memory
    before and its peak after, the encoding phases and the wall."""
    subjects = list(range(NSD73K["encoding_subjects"]))
    regions = NSD_REGIONS[: NSD73K["n_regions"]]
    rss_before = host_rss_gb()
    with store_probe() as store:
        run = drive([
            "load_model_from=torchvision", "model_name=ResNet50", "pretrained_dataset=none",
            "neural_dataset=nsd", "analysis=encoding_score", "encoding_cv_precision=high",
            f"subject_idx={json.dumps(subjects)}", f"region={json.dumps(regions)}",
            "bootstrap=true", "n_bootstrap=1000", "srp_k=4096", "extract_pre_and_post=true",
            "acts_store=host", "uint8_transfer=true", "log_expdata=true", "batchsize=256",
            "num_workers=8"])
    results = run["results"]
    rows = db_rows("analysis = 'encoding_score' AND model_name = 'ResNet50'")
    n_pairs = len(subjects) * len(regions)
    problems = []
    want = ("host", "float32", "cpu")
    if (store.get("store"), store.get("dtype"), store.get("device")) != want \
            or store.get("retained"):
        problems.append(f"store {store}: expected {want}, unretained")
    if len(results) != n_pairs or len(rows) != n_pairs:
        problems.append(f"{len(results)} results and {len(rows)} rows, expected {n_pairs}")
    for r in results:
        vals = [r["score"], r["ci_low"], r["ci_high"], *r["bootstrap_scores"]]
        if len(r["layer_selection_scores"]) != 18 or len(r["bootstrap_scores"]) != 1000 \
                or not all(math.isfinite(v) for v in vals) \
                or not -1.0 <= r["ci_low"] <= r["ci_high"] <= 1.0:
            problems.append(f"bad encoding result for {r['layer']}")
    if run["launches"]:
        problems.append(f"the encoding eval launched the RDM kernel {run['launches']} times")
    phases = run["phases"]
    n_stimuli = NSD73K["n_shared"] + len(subjects) * NSD73K["n_unique"]
    emit({"phase": "nsd73k_encoding", "seconds": run["seconds"], "n_stimuli": n_stimuli,
          "store": store, "host_store_gb": store.get("store_gb"),
          "host_rss_before_gb": rss_before, "host_peak_rss_gb": host_peak_rss_gb(),
          "images_per_s": n_stimuli / phases["extraction_s"],
          "phase_times_s": phases, "peak_mem_gb": run["peak_mem_gb"], "n_results": len(results),
          "db_rows": len(rows), "rdm_launches": run["launches"],
          "scores": [{"layer": r["layer"], "score": r["score"],
                      "ci": [r["ci_low"], r["ci_high"]]} for r in results],
          "problems": problems})
    if problems:
        raise RuntimeError("; ".join(problems))

def phase_decode(tmp: Path) -> dict:
    """The C++ JPEG/PNG decoder where the script runs: whether it builds (with
    the compiler's message when it does not); where it builds,
    decode_batch and decode_batch_u8 against the port's PIL transform on
    THINGS' JPEG pool within tests/test_native_decode.py's bounds; and the
    images/s of each route that runs here through the eval's loader
    (THINGS' batch and num_workers, uint8 feed, decode cache off)."""
    import numpy as np

    from visreps_tpu_torch import native
    from visreps_tpu_torch.benchmarks import fixture
    from visreps_tpu_torch.data import loader
    from visreps_tpu_torch.data.transforms import get_transform, load_image

    t0 = time.perf_counter()
    fixture.ensure_things_fixture(tmp / "fixture", **THINGS)
    pool = [str(p) for p in fixture.ensure_jpeg_pool(tmp / "fixture", THINGS["n_jpeg"],
                                                     THINGS["img_size"])]
    fixture_s = time.perf_counter() - t0
    available = native.native_available()
    rec = {"phase": "decode", "native_available": available, "build_error": native.BUILD_ERROR,
           "fixture_s": fixture_s, "n_images": DECODE["n_images"], "batch": DECODE["batch"],
           "num_workers": DECODE["workers"]}
    problems = []
    if available:
        paths = pool[: DECODE["check"]]
        got = native.decode_batch(paths)
        ref = np.stack([get_transform("imgnet")(load_image(p)) for p in paths])
        diff = np.abs(got - ref).reshape(len(paths), -1)
        got8 = native.decode_batch_u8(paths)
        ref8 = np.stack([get_transform("imgnet", normalize=False)(load_image(p)) for p in paths])
        diff8 = np.abs(got8.astype(np.int16) - ref8.astype(np.int16)).reshape(len(paths), -1)
        rec["vs_pil"] = {"n": len(paths), "mean_abs": float(diff.mean(1).max()),
                         "max_abs": float(diff.max()), "u8_mean": float(diff8.mean(1).max()),
                         "u8_max": int(diff8.max()), "bounds": NATIVE_TOL}
        if not (rec["vs_pil"]["mean_abs"] < NATIVE_TOL["mean"]
                and rec["vs_pil"]["max_abs"] < NATIVE_TOL["max"]
                and rec["vs_pil"]["u8_mean"] < NATIVE_TOL["u8_mean"]
                and rec["vs_pil"]["u8_max"] <= NATIVE_TOL["u8_max"]):
            problems.append(f"native decode off PIL's beyond its bounds: {rec['vs_pil']}")

    stimuli = {f"img{i:05d}": p for i, p in enumerate(pool[: DECODE["n_images"]])}
    cap, real_available = os.environ.get("VISREPS_DECODE_CACHE_MAX"), native.native_available
    os.environ["VISREPS_DECODE_CACHE_MAX"] = "0"
    try:
        for route in ("native", "pil") if available else ("pil",):
            native.native_available = real_available if route == "native" else (lambda: False)
            dl = loader.make_stimuli_loader(stimuli, get_transform("imgnet", normalize=False),
                                            DECODE["batch"], DECODE["workers"])
            before = Counter(loader.ROUTES)
            t0 = time.perf_counter()
            n = sum(len(keys) for _, keys in dl)
            secs = time.perf_counter() - t0
            served = dict(Counter(loader.ROUTES) - before)
            if served != {route: len(stimuli)} or n != len(stimuli):
                problems.append(f"the {route} pass served {served}")
            rec[f"{route}_images_per_s"] = n / secs
    finally:
        native.native_available = real_available
        if cap is None:
            os.environ.pop("VISREPS_DECODE_CACHE_MAX")
        else:
            os.environ["VISREPS_DECODE_CACHE_MAX"] = cap
    emit(rec)
    if problems:
        raise RuntimeError("; ".join(problems))
    return rec


def phase_things(tmp: Path) -> dict:
    """The THINGS eval (stage_things_e2e's configuration) on its fixture:
    1,854 concepts × 14 JPEGs, 66-d embeddings. Checks one result and one
    results.db row with region and subject "N/A", 14 selection scores,
    finite scores and 1000 bootstrap scores, 370 selection and 1,484
    evaluation concepts, the store, the concept means and the selected
    layer's re-extracted means on the card, and 14 + 1 + 2 RDM launches.
    The decode cache: on, holding every id after the first pass, and the
    re-extraction pass decodes nothing (every batch from the cache).
    Prints each pass's decode routes, the cache's entries and bytes, and
    the host's peak RSS before and after."""
    import torch

    from visreps_tpu_torch import evals
    from visreps_tpu_torch.benchmarks import fixture
    from visreps_tpu_torch.data import loader
    from visreps_tpu_torch.models.extractor import FeatureExtractor

    t0 = time.perf_counter()
    meta = fixture.ensure_things_fixture(tmp / "fixture", **THINGS)
    fixture_s = time.perf_counter() - t0
    seen = Counter()
    passes = {}  # per pass: the decode routes, and the cache after the first
    rss_before = host_peak_rss_gb()
    originals = {"prepare": evals.prepare_concept_alignment,
                 "align": evals.compute_traintest_alignment,
                 "mean": FeatureExtractor.extract_single_layer_mean,
                 "single": FeatureExtractor.extract_single_layer,
                 "acts": FeatureExtractor.get_activations}

    def routed(name, fn, dl):
        before = Counter(loader.ROUTES)
        out = fn()
        passes[name] = {"routes": dict(Counter(loader.ROUTES) - before),
                        "cache_on": dl.dataset.cache_enabled, **dl.dataset.cache_stats()}
        return out

    def acts(self, dl, *args, **kwargs):
        return routed("extraction", lambda: originals["acts"](self, dl, *args, **kwargs), dl)

    def prepare(cfg, acts, *args):
        seen.update(f"store {a.device.type} {a.dtype}" for a in acts.values())
        out = originals["prepare"](cfg, acts, *args)
        seen.update(f"concept means {a.device.type} {a.dtype}" for a in out.activations.values())
        return out

    def align(cfg, selection, evaluation, **kwargs):
        seen[f"concepts {selection.neural.shape[0]} / {evaluation.neural.shape[0]}"] += 1
        return originals["align"](cfg, selection, evaluation, **kwargs)

    def mean(self, dl, *args, **kwargs):
        out = routed("re_extraction", lambda: originals["mean"](self, dl, *args, **kwargs), dl)
        seen[f"re-extracted means {out[0].device.type} {tuple(out[0].shape)}"] += 1
        return out

    def single(self, dl, *args, **kwargs):
        seen["host re-extraction"] += 1
        return routed("re_extraction", lambda: originals["single"](self, dl, *args, **kwargs), dl)

    cwd = os.getcwd()
    os.chdir(meta["root"])  # the loader reads datasets/neural/things/ relative to it
    evals.prepare_concept_alignment, evals.compute_traintest_alignment = prepare, align
    FeatureExtractor.extract_single_layer_mean = mean
    FeatureExtractor.extract_single_layer = single
    FeatureExtractor.get_activations = acts
    try:
        run = drive([*RSA_OVERRIDES, "neural_dataset=things-behavior", "uint8_transfer=true",
                     "batchsize=512"])
    finally:
        os.chdir(cwd)
        evals.prepare_concept_alignment = originals["prepare"]
        evals.compute_traintest_alignment = originals["align"]
        FeatureExtractor.extract_single_layer_mean = originals["mean"]
        FeatureExtractor.extract_single_layer = originals["single"]
        FeatureExtractor.get_activations = originals["acts"]
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
    n = meta["n_images"]
    first, second = passes.get("extraction", {}), passes.get("re_extraction", {})
    decoded = sum(v for k, v in second.get("routes", {}).items() if k != "cache")
    if not first.get("cache_on") or first.get("entries") != n or sum(first["routes"].values()) != n:
        problems.append(f"the first pass did not fill the decode cache: {first}")
    if decoded or second.get("routes", {}).get("cache") != n:
        problems.append(f"the re-extraction decoded {decoded} items: {second}")
    if problems:
        raise RuntimeError("; ".join(problems))
    check_launches(run, 14 + 1 + 2, "14 selection + 1 embedding + 2 evaluation RDMs")
    eval_record("things", run, meta["n_images"], fixture_s, n_concepts=meta["n_concepts"],
                n_jpeg=meta["n_jpeg"], db_rows=rows, probes=dict(seen), passes=passes,
                re_extraction_decoded=decoded,
                scoring_re_extract_s=run["phases"]["scoring_re_extract_s"],
                host_peak_rss_gb={"before": rss_before, "after": host_peak_rss_gb()})
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


def phase_train(tmp: Path) -> tuple[str, dict]:
    """Train CustomCNN on PCA labels through the CLI's entry point; returns
    the checkpoint directory the eval reads (``{dir}`` of ``{dir}/cfg32a``)
    and the fixture's overrides (``dataset_path``, ``label_file``,
    ``pca_labels_folder``, with CSVs for the runners' granularities too)."""
    import torch

    from visreps_tpu_torch import run
    from visreps_tpu_torch.benchmarks.fixture import write_imagenet_fixture
    from visreps_tpu_torch.data import loader
    from visreps_tpu_torch.models.convert import params_from_jax
    from visreps_tpu_torch.train import checkpoint as ckpt
    from visreps_tpu_torch.train import trainer as trainer_mod

    t0 = time.perf_counter()
    data = write_imagenet_fixture(tmp / "imagenet", TRAIN["n_images"],
                                  pca_n_classes=[TRAIN["pca_n_classes"], *RUNNERS["pca_n_classes"]])
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
    routes = Counter(loader.ROUTES)
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
          "decode_routes": dict(Counter(loader.ROUTES) - routes),
          "metrics_csv": (run_dir / "training_metrics.csv").read_text().splitlines(),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return checkpoint_dir, data


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


def forward_flops(name: str, num_classes: int = 1000) -> float:
    """FLOPs (2 × multiply-adds) of one forward of ``name`` on one 224 px
    image: ``torch.utils.flop_counter`` over a forward on the meta device
    (convolutions, matmuls and the attention products; norms, pooling and
    activations are not counted)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from visreps_tpu_torch.models.zoo import MODEL_REGISTRY

    with torch.device("meta"):
        model = MODEL_REGISTRY[name](num_classes=num_classes).eval()
        x = torch.empty((1, 3, 224, 224))
    with FlopCounterMode(display=False) as counter:
        model(x)
    return float(counter.get_total_flops())


def _family_model(name: str, device: str, dropout: bool = True):
    """``name`` at full width, 1000 classes, from seed 0 (dropout 0 when
    ``dropout`` is False), on ``device``."""
    import torch

    from visreps_tpu_torch.models.zoo import MODEL_REGISTRY, init_model

    if dropout or name not in ("VGG16", "ECTiedNet"):
        return init_model(name, STEP["classes"], seed=0, device=device)
    model = MODEL_REGISTRY[name](num_classes=STEP["classes"], dropout=0.0)
    model.init_weights(torch.Generator().manual_seed(0))
    return model.to(device)


def bn_route_probe() -> str:
    """Whether ``F.batch_norm`` on the card takes a bf16 input with bf16
    affine parameters beside f32 running statistics (the JAX bf16 step's
    dtypes): "accepted", or torch's message. The port's BatchNorm widens
    the bf16 scale and bias to f32 for the call either way
    (``models/layers.py``)."""
    import torch
    import torch.nn.functional as F

    x = torch.randn((8, 4, 5, 5), device="cuda", dtype=torch.bfloat16)
    w = torch.ones(4, device="cuda", dtype=torch.bfloat16)
    stats = (torch.zeros(4, device="cuda"), torch.ones(4, device="cuda"))
    try:
        F.batch_norm(x, *stats, w, torch.zeros_like(w), True, 0.1, 1e-5)
    except RuntimeError as e:
        return str(e).splitlines()[0]
    return "accepted"


def phase_train_families():
    """The train step of each family (``train/trainer.train_step``, AdamW,
    1000 classes, batch 256) in f32 and in bf16 compute: ms per step over
    FAMILY_STEP's iterations after a warm-up, images/s, peak memory and
    the bound (3 × forward FLOPs × batch over the card's f32 FMA or bf16
    peak). Then each family's f32 step at batch 8 without dropout on
    the card against the same step on the CPU."""
    import torch

    from visreps_tpu_torch.train.optim import Optimizer
    from visreps_tpu_torch.train.trainer import train_step

    cfg = _step_cfg()
    emit({"phase": "train_families", "bn_bf16_affine_f32_stats": bn_route_probe()})
    failures = []
    for name in FAMILY_STEP["families"]:
        flops = forward_flops(name)
        for dtype_name in FAMILY_STEP["dtypes"]:
            dtype = getattr(torch, dtype_name)
            batch = STEP["batch"]  # every family fits (ViT-B f32 peaks at 37.7 GB)
            model = _family_model(name, "cuda")
            opt = Optimizer(model, cfg, 100)
            gen = torch.Generator(device="cuda").manual_seed(0)
            images = torch.randn((batch, 3, 224, 224), device="cuda", generator=gen)
            labels = torch.arange(batch, device="cuda") % STEP["classes"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            train_step(model, opt, images, labels, gen, 0, dtype)  # warm-up
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(FAMILY_STEP["iters"]):
                loss, grad_norm = train_step(model, opt, images, labels, gen, 1 + i, dtype)
            stop.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(stop) / FAMILY_STEP["iters"]
            peak = FMA_PEAK_OPS[dtype_name]
            bound_ms = 1e3 * 3 * flops * batch / peak
            f32_state = all(p.dtype == torch.float32 for p in model.parameters()) and all(
                v.dtype == torch.float32 for s in opt.opt.state.values() for k, v in s.items()
                if k != "step")
            emit({"phase": "train_families", "model": name, "dtype": dtype_name, "batch": batch,
                  "ms_per_step": ms, "images_per_s": batch / ms * 1e3,
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "forward_gflop_per_image": flops / 1e9, "bound_ms": bound_ms,
                  "bound_share": bound_ms / ms, "bound_by": "operations",
                  "bound_peak": f"{dtype_name} {peak / 1e12:g} TFLOP/s",
                  "loss": loss.item(), "grad_norm": grad_norm.item(),
                  "f32_params_and_state": f32_state})
            if not (math.isfinite(loss.item()) and math.isfinite(grad_norm.item())):
                failures.append(f"{name} {dtype_name}: non-finite loss or gradient norm")
            if not f32_state:
                failures.append(f"{name} {dtype_name}: parameters or optimizer state not f32")
            del model, opt, images, labels, loss, grad_norm
            torch.cuda.empty_cache()

        b = STEP["parity_batch"]
        x = torch.randn((b, 3, 224, 224), generator=torch.Generator().manual_seed(1))
        y = torch.arange(b) % STEP["classes"]
        out = {}
        for dev in ("cpu", "cuda"):
            m = _family_model(name, dev, dropout=False)
            o = Optimizer(m, cfg, 100)
            lo, gn = train_step(m, o, x.to(dev), y.to(dev), None, 0)
            out[dev] = (lo.item(), gn.item(),
                        {k: v.cpu() for k, v in m.state_dict().items() if "running_" in k})
            del m, o
        (l_cpu, g_cpu, s_cpu), (l_gpu, g_gpu, s_gpu) = out["cpu"], out["cuda"]
        stat_err = max([((s_gpu[k] - s_cpu[k]).abs().max() / s_cpu[k].abs().max()).item()
                        for k in s_cpu] or [0.0])
        parity = {"batch": b, "loss": [l_cpu, l_gpu], "grad_norm": [g_cpu, g_gpu],
                  "bn_stats_max_rel_err": stat_err, "rtol": STEP_RTOL}
        emit({"phase": "train_families", "model": name, "parity": parity})
        if not (abs(l_gpu - l_cpu) <= STEP_RTOL * abs(l_cpu)
                and abs(g_gpu - g_cpu) <= STEP_RTOL * abs(g_cpu) and stat_err <= STEP_RTOL):
            failures.append(f"{name}: the card's f32 step disagrees with the CPU's: {parity}")
        torch.cuda.empty_cache()
    if failures:
        raise RuntimeError("; ".join(failures))


def phase_train_resume(meta: dict, tmp: Path, data: dict) -> dict:
    """ResNet18 through ``Trainer`` (configs/train/base.json, PCA labels,
    batch 256, AdamW) for 2 epochs with ``save_resume_state`` and
    ``checkpoint_interval=1`` on the train phase's JPEGs; a second Trainer
    from a copy of its directory with ``resume_from_epoch=1``, which must
    start at epoch 2 with the saved optimizer state; its epoch-2 losses
    beside the uninterrupted run's; then the NSD RSA eval of the resumed
    run's epoch-2 checkpoint (``load_model_from=checkpoint``), with e2e's
    checks. Every step's batch and model must be on the card."""
    import torch

    from visreps_tpu_torch.core.config import load_config
    from visreps_tpu_torch.models.zoo import TORCHVISION_RETURN_NODES
    from visreps_tpu_torch.run import validate_config
    from visreps_tpu_torch.train import trainer as trainer_mod

    n_cls = RESUME["pca_n_classes"]
    first_dir = tmp / "resume_first"

    def cfg(checkpoint_dir, *extra):
        return validate_config(load_config(str(ROOT / "configs/train/base.json"), [
            "mode=train", "model_class=standard_model", f"model_name={RESUME['model']}",
            "pretrained_dataset=none", "pca_labels=true", f"pca_n_classes={n_cls}",
            f"batchsize={TRAIN['batch']}", f"num_epochs={TRAIN['epochs']}", "warmup_epochs=1",
            "num_workers=16", "log_interval=1", "checkpoint_interval=1", "log_checkpoints=true",
            f"checkpoint_dir={checkpoint_dir}", "save_resume_state=true",
            *(f"{k}={v}" for k, v in data.items()), *extra]))

    devices = []
    step_fn = trainer_mod.train_step

    def probe(model, optimizer, images, labels, *args, **kwargs):
        devices.append(({images.device.type, labels.device.type},
                        {p.device.type for p in model.parameters()}))
        return step_fn(model, optimizer, images, labels, *args, **kwargs)

    trainer_mod.train_step = probe
    try:
        t0 = time.perf_counter()
        first = trainer_mod.Trainer(cfg(first_dir), device="cuda")
        first.train()
        first_s = time.perf_counter() - t0
        run_dir = first_dir / f"cfg{n_cls}a"
        resumed_dir = tmp / "resume_second"
        shutil.copytree(first_dir, resumed_dir)
        t0 = time.perf_counter()
        second = trainer_mod.Trainer(cfg(resumed_dir, "resume_from_epoch=1"), device="cuda")
        saved = torch.load(run_dir / "resume_epoch_1.pt", map_location="cpu", weights_only=True)
        state = second.optimizer.named_state()
        same_state = set(state) == set(saved["state"]) and all(
            torch.equal(v.cpu(), saved["state"][n][k])
            for n, entry in state.items() for k, v in entry.items())
        second.train()
        torch.cuda.synchronize()
        second_s = time.perf_counter() - t0
    finally:
        trainer_mod.train_step = step_fn
    steps = first.steps_per_epoch
    if not all(b == {"cuda"} and p == {"cuda"} for b, p in devices):
        raise RuntimeError("a train step ran with the batch or the model off the card")
    if len(devices) != 3 * steps or len(second.history) != steps:
        raise RuntimeError(f"{len(devices)} steps in the two runs, {len(second.history)} after "
                           f"the resume; expected {3 * steps} and {steps}")
    if (second.start_epoch, second.global_step) != (2, 2 * steps) or not same_state:
        raise RuntimeError(f"the resume did not restore epoch 1's state: start_epoch "
                           f"{second.start_epoch}, same optimizer state {same_state}")
    losses = [h["loss"] for h in first.history + second.history]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite losses: {losses}")
    files = sorted(p.name for p in run_dir.iterdir())
    emit({"phase": "train_resume", "model": RESUME["model"], "steps_per_epoch": steps,
          "uninterrupted_epoch2_loss": [h["loss"] for h in first.history[steps:]],
          "resumed_epoch2_loss": [h["loss"] for h in second.history],
          "epoch1_loss": [h["loss"] for h in first.history[:steps]],
          "resumed_start": [second.start_epoch, second.global_step],
          "optimizer_state_restored": same_state, "files": files,
          "first_run_s": first_s, "resumed_run_s": second_s})
    del first, second
    torch.cuda.empty_cache()
    nodes = TORCHVISION_RETURN_NODES[RESUME["model"]]  # the eval's config names AlexNet's
    return run_eval("train_resume_eval", meta, [
        "load_model_from=checkpoint", f"cfg_id={n_cls}", f"checkpoint_dir={resumed_dir}",
        f"checkpoint_model=checkpoint_epoch_{TRAIN['epochs']}.pth",
        f"return_nodes={json.dumps(nodes)}"],
        f"cfg_id = {n_cls} AND epoch = {TRAIN['epochs']}",
        lambda cfg_id, epoch: cfg_id == n_cls and epoch == TRAIN["epochs"],
        n_taps=RESUME["taps"])


def phase_trace(meta: dict, tmp: Path, data: dict) -> dict:
    """``core/profiling.trace`` around the e2e eval (``run_eval``, with all
    its checks) and around 10 trainer steps (``run.main`` in train_step's
    configuration on the train phase's images). For each trace: the
    device's busy share over the traced window (the union of kernel,
    memcpy and memset intervals), the five device operations that took
    the most time and the five longest idle gaps with the host operation
    across each (``profiling.summarize_trace``), and the trace's size."""
    import torch

    from visreps_tpu_torch import run
    from visreps_tpu_torch.core import profiling

    out = {"phase": "trace"}
    with profiling.trace(tmp / "traces") as path:
        t0 = time.perf_counter()
        ev = run_eval("trace_e2e", meta, ["load_model_from=torchvision", "model_name=AlexNet",
                                          "pretrained_dataset=none"],
                      "cfg_id = 'untrained'", lambda cfg_id, epoch: epoch == -1)
        traced_s = time.perf_counter() - t0
    out["e2e"] = {"wall_s": ev["seconds"], "traced_s": traced_s,
                  "trace_mb": path.stat().st_size / 1e6, **profiling.summarize_trace(path)}
    path.unlink()

    steps_per_epoch = int(TRAIN["n_images"] * 0.8) // STEP["batch"]
    if steps_per_epoch * TRACE_TRAIN["epochs"] != TRACE_TRAIN["steps"]:
        raise RuntimeError("the train fixture does not give the traced step count")
    torch.cuda.synchronize()
    with profiling.trace(tmp / "traces") as path:
        t0 = time.perf_counter()
        trainer = run.main([
            "--mode", "train", "--config", str(ROOT / "configs/train/base.json"), "--override",
            "pca_labels=false", f"batchsize={STEP['batch']}",
            f"num_epochs={TRACE_TRAIN['epochs']}", "warmup_epochs=1", "num_workers=16",
            "log_interval=1000", "log_checkpoints=false", *(f"{k}={v}" for k, v in data.items())])
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    if len(trainer.history) != TRACE_TRAIN["steps"] or trainer.model.fc3.out_features != 1000:
        raise RuntimeError(f"{len(trainer.history)} traced steps, expected "
                           f"{TRACE_TRAIN['steps']} at 1000 classes")
    out["train"] = {"steps": len(trainer.history), "traced_s": traced_s,
                    "loader_wait_s": trainer.loader_wait_s,
                    "trace_mb": path.stat().st_size / 1e6, **profiling.summarize_trace(path)}
    path.unlink()
    emit(out)
    if not all(0 < out[k]["busy_share"] <= 1 and out[k]["n_device_events"] for k in ("e2e", "train")):
        raise RuntimeError("a trace holds no device work")
    return out


def _cli_exit(main, argv: list[str]) -> int:
    """The exit code a runner CLI ends with."""
    try:
        main(argv)
    except SystemExit as e:
        return e.code or 0
    return 0


def phase_runners(tmp: Path, data: dict) -> dict:
    """The sweep runners as a user runs them on the card: ``train_runner``
    over a grid of seed 1 × pca_n_classes RUNNERS["pca_n_classes"], 1 epoch
    each, on the train phase's images; then ``eval_runner`` over the
    checkpoints (the e2e eval's configuration from a config file,
    eval_checkpoint_at_epoch 1). Every run is a ``python -m
    visreps_tpu_torch.run`` subprocess. Checks both runners' exit codes
    (0 only when every run exited 0), the checkpoint files, and 4
    results.db rows per cfg_id at epoch 1."""
    import torch

    from visreps_tpu_torch.runners import eval_runner, train_runner

    torch.cuda.empty_cache()  # the subprocesses share the card
    ckpt_dir = tmp / "runner_checkpoints"
    train_grid, eval_grid, eval_cfg = (tmp / "train_grid.json", tmp / "eval_grid.json",
                                       tmp / "eval_config.json")
    train_grid.write_text(json.dumps({
        "seed": 1, "pca_labels": True, "pca_n_classes": RUNNERS["pca_n_classes"],
        "num_epochs": RUNNERS["epochs"], "warmup_epochs": 0, "batchsize": TRAIN["batch"],
        "num_workers": 16, "log_interval": 1, "checkpoint_interval": 1,
        "log_checkpoints": True, "checkpoint_dir": str(ckpt_dir), **data}))
    eval_grid.write_text(json.dumps({
        "seed": 1, "cfg_id": RUNNERS["pca_n_classes"], "checkpoint_dir": str(ckpt_dir),
        "eval_checkpoint_at_epoch": RUNNERS["epochs"]}))
    cfg = json.loads((ROOT / "configs/eval/base.json").read_text())
    cfg.update({"neural_dataset": "nsd", "analysis": "rsa", "compare_method": "spearman",
                "subject_idx": list(range(E2E["n_subjects"])),
                "region": NSD_REGIONS[: E2E["n_regions"]], "bootstrap": True,
                "n_bootstrap": 1000, "n_select": 1000, "srp_k": 4096,
                "extract_pre_and_post": True, "uint8_transfer": True, "batchsize": 256,
                "num_workers": 8})
    eval_cfg.write_text(json.dumps(cfg))
    pythonpath = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT), pythonpath]))
    try:
        t0 = time.perf_counter()
        train_rc = _cli_exit(train_runner.main, [
            "--grid", str(train_grid), "--config", str(ROOT / "configs/train/base.json")])
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eval_rc = _cli_exit(eval_runner.main, ["--grid", str(eval_grid), "--config", str(eval_cfg)])
        eval_s = time.perf_counter() - t0
    finally:
        if pythonpath is None:
            os.environ.pop("PYTHONPATH")
        else:
            os.environ["PYTHONPATH"] = pythonpath
    ckpts = {k: (ckpt_dir / f"cfg{k}a" / f"checkpoint_epoch_{RUNNERS['epochs']}.pth").is_file()
             for k in RUNNERS["pca_n_classes"]}
    rows = Counter(r[3] for r in db_rows(
        f"epoch = {RUNNERS['epochs']} AND cfg_id IN ({', '.join(map(str, ckpts))})"))
    n_pairs = E2E["n_subjects"] * E2E["n_regions"]
    rec = {"phase": "runners", "train_runner_rc": train_rc, "eval_runner_rc": eval_rc,
           "train_runner_s": train_s, "eval_runner_s": eval_s, "checkpoints": ckpts,
           "db_rows_per_cfg_id": dict(rows), "runs": 2 * len(ckpts)}
    emit(rec)
    if train_rc or eval_rc or not all(ckpts.values()) \
            or rows != {k: n_pairs for k in RUNNERS["pca_n_classes"]}:
        raise RuntimeError(f"the runners' sweep failed: {rec}")
    return rec


E2E_SOURCE = ["load_model_from=torchvision", "model_name=AlexNet", "pretrained_dataset=none"]
# e2e's results.db rows among the other evals' in the same database
E2E_ROWS = ("cfg_id = 'untrained' AND compare_method = 'spearman' AND "
            "reconstruct_from_pcs = 0 AND neural_dataset = 'nsd' AND subject_idx "
            "IN ('0', '1') AND region IN ('early visual stream', 'ventral visual stream')")


def untrained(cfg_id, epoch) -> bool:
    return epoch == -1


class Scoring:
    """While in use, ``evals._score_pairs`` keeps its inputs (model RDMs,
    neural response matrices, the layer of each pair) in ``args``, and
    the per-pair route's point-score and bootstrap calls add their
    seconds (each between two device synchronises) to ``seconds``."""

    def __enter__(self):
        import torch

        from visreps_tpu_torch import evals

        self.args, self.seconds = {}, {"point_s": 0.0, "bootstrap_s": 0.0}
        self.saved = {k: getattr(evals, k) for k in (
            "_score_pairs", "compute_rdm_correlation_batched", "bootstrap_rdm_correlation")}

        def keep(cfg, model_rdms, neural_mats, pair_layer, *rest):
            self.args.update(model_rdms=dict(model_rdms), neural_mats=dict(neural_mats),
                             pair_layer=dict(pair_layer))
            return self.saved["_score_pairs"](cfg, model_rdms, neural_mats, pair_layer, *rest)

        def timed(key, fn):
            def call(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                self.seconds[key] += time.perf_counter() - t0
                return out
            return call

        evals._score_pairs = keep
        evals.compute_rdm_correlation_batched = timed(
            "point_s", self.saved["compute_rdm_correlation_batched"])
        evals.bootstrap_rdm_correlation = timed("bootstrap_s",
                                                self.saved["bootstrap_rdm_correlation"])
        return self

    def __exit__(self, *exc):
        from visreps_tpu_torch import evals

        for k, fn in self.saved.items():
            setattr(evals, k, fn)

    def pair_rdms(self, pair):
        """The pair's model RDM and its neural RDM (built here, after the
        eval's launch count was read)."""
        import torch

        from visreps_tpu_torch.ops.rdm import compute_rdm

        neural = torch.as_tensor(self.args["neural_mats"][pair], device="cuda")
        return self.args["model_rdms"][self.args["pair_layer"][pair]], compute_rdm(neural)


def same_selection(run: dict, ref: dict, what: str) -> list:
    """Problems where ``run`` selected other layers than ``ref``."""
    got, want = [r["layer"] for r in run["results"]], [r["layer"] for r in ref["results"]]
    return [] if got == want else [f"{what} selected {got}, e2e {want}"]


def phase_kendall(meta: dict, e2e_run: dict) -> dict:
    """The e2e eval with compare_method=kendall: Kendall selection (all
    R × 14 taus of a subject in one batched call), the per-pair route's
    batched point scores and the block-contraction bootstrap. Checks
    results, rows (compare_method kendall), finite scores, 1000
    bootstraps and S·(T + R) + U + P launches; then, on the first pair's
    RDMs and the first KENDALL_CHECK["iters"] index sets, that
    ``bootstrap_kendall_fast`` equals ``kendall_tau_a`` of each gathered
    sub-triangle within KENDALL_CHECK["tol"], the eval's own bootstrap
    scores, and the same function on the CPU within KENDALL_CHECK["cpu_tol"]."""
    import torch

    from visreps_tpu_torch.ops.bootstrap import bootstrap_indices, gathered_scores
    from visreps_tpu_torch.ops.kendall import bootstrap_kendall_fast

    with Scoring() as scoring:
        run = run_eval("kendall", meta, E2E_SOURCE,
                       "cfg_id = 'untrained' AND compare_method = 'kendall'", untrained,
                       options=("compare_method=kendall",))
    with sqlite3.connect(os.environ["VISREPS_RESULTS_DB"]) as conn:
        methods = {m for (m,) in conn.execute(
            "SELECT compare_method FROM results WHERE cfg_id = 'untrained' AND "
            "compare_method = 'kendall'")}
    problems = [] if methods == {"kendall"} else [f"results.db methods {methods}"]
    problems += [f"result method {r['compare_method']}" for r in run["results"]
                 if r["compare_method"] != "kendall"]

    pair = next(iter(scoring.args["pair_layer"]))
    model, neural = scoring.pair_rdms(pair)
    n = model.shape[0]
    idx = bootstrap_indices(n, 1000, seed=42)[: KENDALL_CHECK["iters"]]
    fast = bootstrap_kendall_fast(model, neural, idx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fast = bootstrap_kendall_fast(model, neural, idx)
    torch.cuda.synchronize()
    fast_s = time.perf_counter() - t0
    per_iter = gathered_scores(model, neural, torch.as_tensor(idx, device="cuda").long(),
                               "kendall", chunk=KENDALL_CHECK["iters"])
    cpu = bootstrap_kendall_fast(model.cpu(), neural.cpu(), idx)
    own = torch.as_tensor(run["results"][0]["bootstrap_scores"][: KENDALL_CHECK["iters"]])
    checks = {"pair": list(pair), "iters": len(idx),
              "vs_per_iteration": (fast - per_iter).abs().max().item(),
              "vs_eval": (fast.double().cpu() - own).abs().max().item(),
              "vs_cpu": (fast.cpu() - cpu).abs().max().item(),
              "tol": KENDALL_CHECK["tol"], "cpu_tol": KENDALL_CHECK["cpu_tol"],
              "fast_s_for_iters": fast_s}
    if not checks["vs_per_iteration"] <= KENDALL_CHECK["tol"]:
        problems.append(f"bootstrap_kendall_fast vs kendall_tau_a {checks['vs_per_iteration']}")
    if not checks["vs_eval"] <= KENDALL_CHECK["tol"]:
        problems.append(f"bootstrap_kendall_fast vs the eval's scores {checks['vs_eval']}")
    if not checks["vs_cpu"] <= KENDALL_CHECK["cpu_tol"]:
        problems.append(f"bootstrap_kendall_fast card vs CPU {checks['vs_cpu']}")
    phases = run["phases"]
    emit({"phase": "kendall_check", **checks,
          "selection_s": phases["phase1_selection_s"], **scoring.seconds,
          "scoring_bootstrap_s": phases["scoring_bootstrap_s"], "problems": problems})
    if problems:
        raise RuntimeError("; ".join(problems))
    return run


def tie_broken(rdm):
    """The RDM with its upper triangle replaced by the triangle's dense
    ranks (stable: ties in triangle order), mirrored: a tie-free RDM with
    the same stable sorted order, so its dense-rank scores are the
    original's and equal its average-tie scores."""
    import torch

    from visreps_tpu_torch.ops.rdm import triu_indices
    from visreps_tpu_torch.ops.stats import rankdata_dense

    iu, ju = triu_indices(rdm.shape[0], rdm.device)
    ranks = rankdata_dense(rdm[iu, ju])
    out = torch.zeros_like(rdm)
    out[iu, ju] = ranks
    out[ju, iu] = ranks
    return out


def phase_dense_boot(meta: dict, e2e_run: dict) -> dict:
    """The e2e eval with bootstrap_exact_ties=false: per-pair dense-rank
    Spearman bootstraps. Its layers must be e2e's and its point scores
    within DENSE_TOL of e2e's (both average-tie: grouped there, batched
    here). The fixture's RDM triangles are full of exact ties (f32 values
    of near-equal correlations), so the dense bootstrap is held against
    the grouped average-tie path (``bootstrap_rdm_correlation_grouped``)
    on tie-broken copies of each pair's RDMs (``tie_broken``: the dense
    order made strict), within DENSE_TOL; the difference tie handling
    makes on the original RDMs is printed beside it."""
    import numpy as np

    from visreps_tpu_torch.ops.bootstrap import (
        bootstrap_indices,
        bootstrap_rdm_correlation_grouped,
    )
    from visreps_tpu_torch.ops.rdm import triangle_tie_count

    with Scoring() as scoring:
        run = run_eval("dense_boot", meta, E2E_SOURCE, E2E_ROWS, untrained,
                       options=("bootstrap_exact_ties=false",))
    problems = same_selection(run, e2e_run, "dense_boot")
    # bootstrap_exact_ties is no identity field: these rows replaced e2e's
    # under the same run ids, so the stored distributions must be this run's.
    stored = sorted(db_bootstraps(E2E_ROWS))
    if stored != sorted(r["bootstrap_scores"] for r in run["results"]):
        problems.append("results.db bootstrap distributions are not this run's")
    point_diff = max(abs(a["score"] - b["score"])
                     for a, b in zip(run["results"], e2e_run["results"]))
    if not point_diff <= DENSE_TOL:
        problems.append(f"point scores differ from e2e's by {point_diff}")
    pairs = list(scoring.args["pair_layer"])
    rdms = {p: scoring.pair_rdms(p) for p in pairs}
    idx = bootstrap_indices(next(iter(rdms.values()))[0].shape[0], 1000, seed=42)
    dense = {p: np.asarray(r["bootstrap_scores"]) for p, r in zip(pairs, run["results"])}

    def vs_grouped(transform) -> float:
        grouped = bootstrap_rdm_correlation_grouped(
            {p: transform(m) for p, (m, _) in rdms.items()},
            {p: transform(nr) for p, (_, nr) in rdms.items()}, {p: p for p in pairs}, idx)
        return max(float(np.abs(dense[p] - grouped[p]).max()) for p in pairs)

    tie_free = vs_grouped(tie_broken)
    if not tie_free <= DENSE_TOL:
        problems.append(f"dense bootstrap vs grouped on tie-broken RDMs: {tie_free}")
    emit({"phase": "dense_boot_check", "point_vs_e2e": point_diff,
          "triangle_ties": [[triangle_tie_count(m), triangle_tie_count(nr)]
                            for m, nr in rdms.values()],
          "bootstrap_vs_grouped_tie_broken": tie_free,
          "bootstrap_vs_grouped_with_ties": vs_grouped(lambda r: r), "tol": DENSE_TOL,
          "db_bootstraps_differ_from_e2e":
              stored != sorted(r["bootstrap_scores"] for r in e2e_run["results"]),
          "bootstrap_s": scoring.seconds["bootstrap_s"], "point_s": scoring.seconds["point_s"],
          "problems": problems})
    if problems:
        raise RuntimeError("; ".join(problems))
    return run


def reconstruction_check(x) -> dict:
    """At one (n, d) tap: the rank-PCA_K reconstruction of ``fit_pca``
    (an f64 eigh of the n × n Gram) and of an f32 economy SVD
    (``torch.linalg.svd``, cuSOLVER's default route), each against the
    same reconstruction from an f64 SVD (max |Δ| / max |value|), with
    their seconds and the top eigenvalues' relative gap."""
    import torch

    from visreps_tpu_torch.ops.pca import fit_pca

    def secs(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def from_svd(dtype):
        xd = x.to(dtype)
        mean = xd.mean(dim=0)
        _, sv, vt = torch.linalg.svd(xd - mean, full_matrices=False)
        v = vt[:PCA_K]
        return mean + ((xd - mean) @ v.T) @ v, sv

    (ref, sv), svd64_s = secs(lambda: from_svd(torch.float64))
    rec, fit_s = secs(lambda: fit_pca(x, PCA_K).reconstruct(x))
    (rec32, _), svd32_s = secs(lambda: from_svd(torch.float32))
    scale = ref.abs().max().item()
    return {"shape": list(x.shape), "fit_pca_s": fit_s, "svd_f32_s": svd32_s,
            "svd_f64_s": svd64_s, "top_gap": (1 - (sv[1] / sv[0]) ** 2).item(),
            "fit_pca_vs_svd_f64": (rec.double() - ref).abs().max().item() / scale,
            "svd_f32_vs_svd_f64": (rec32.double() - ref).abs().max().item() / scale}


def phase_pca(meta: dict, e2e_run: dict) -> dict:
    """The e2e eval with reconstruct_from_pcs=true pca_k=PCA_K: each
    selected layer's exact taps rebuilt from their top PCs before its
    RDM. Its layers must be e2e's (selection does not see the PCA);
    the seconds of every ``fit_pca`` (between device synchronises) and,
    at the widest tap, ``reconstruction_check``. Then the planted
    encoding subject of encoding_check (Woodbury shape) with
    reconstruct_pca_k=ENC_PCA_K on the card and on the CPU at
    ``highest``, on the alphas ≥ 1 (the reconstructed features have a
    null space whose f32 roundoff decides the smaller alphas), within
    ENC_TOL with the same layers."""
    import torch

    from visreps_tpu_torch.analysis import encoding
    from visreps_tpu_torch.ops import pca as pca_ops
    from visreps_tpu_torch.ops import ridge

    fits, widest = [], {}
    fit_pca = pca_ops.fit_pca

    def timed_fit(x, k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fit_pca(x, k)
        torch.cuda.synchronize()
        fits.append([*x.shape, time.perf_counter() - t0])
        if x.shape[1] > widest.get("d", 0):
            widest.update(d=x.shape[1], x=x.detach().clone())
        return out

    pca_ops.fit_pca = timed_fit
    try:
        run = run_eval("pca", meta, E2E_SOURCE,
                       "cfg_id = 'untrained' AND reconstruct_from_pcs = 1", untrained,
                       options=("reconstruct_from_pcs=true", f"pca_k={PCA_K}"))
    finally:
        pca_ops.fit_pca = fit_pca
    problems = same_selection(run, e2e_run, "pca")
    if len(fits) != len({r["layer"] for r in run["results"]}):
        problems.append(f"{len(fits)} PCA fits for {len(run['results'])} pairs' unique layers")
    check = reconstruction_check(widest.pop("x"))
    if not check["fit_pca_vs_svd_f64"] <= PCA_TOL:
        problems.append(f"fit_pca's reconstruction is {check['fit_pca_vs_svd_f64']} from the "
                        "f64 SVD's")

    protocol_alphas = ridge.default_alphas
    determined = protocol_alphas()[protocol_alphas() >= 1]
    data = planted_subject(*ENC_CHECK["routes"]["woodbury"])

    def fit(device):
        t0 = time.perf_counter()
        out = encoding.compute_encoding_scores_subject(
            *data, n_bootstrap=ENC_CHECK["n_bootstrap"], cv_precision="highest",
            reconstruct_pca_k=ENC_PCA_K, device=device)
        return out, time.perf_counter() - t0

    ridge.default_alphas = encoding.default_alphas = lambda n=20: determined.copy()
    try:
        (card, card_s), (cpu, cpu_s) = fit("cuda"), fit("cpu")
    finally:
        ridge.default_alphas = encoding.default_alphas = protocol_alphas
    enc = compare_encoding(card, cpu)
    if not (enc["same_layers"] and max(enc["score"], enc["ci_low"], enc["ci_high"]) <= ENC_TOL):
        problems.append(f"encoding with reconstruct_pca_k: card vs CPU {enc}")
    emit({"phase": "pca_check", "pca_k": PCA_K, "fits": fits, **check, "tol": PCA_TOL,
          "encoding": {"reconstruct_pca_k": ENC_PCA_K, "alphas": "alphas >= 1",
                       "n_train": data[2]["regA"].shape[0], "cuda_s": card_s, "cpu_s": cpu_s,
                       "cuda_vs_cpu": enc, "tol": ENC_TOL},
          "problems": problems})
    if problems:
        raise RuntimeError("; ".join(problems))
    return run


def phase_encoding_delta() -> None:
    """``encoding_cv_precision`` high against highest on the card (the JAX
    package's stage_encoding_delta): one subject's
    ``compute_encoding_scores_subject`` without bootstrap on seeded
    device data at the stage's shape, y = tap3·W/64 + noise. Prints the
    layers each setting selects, the largest score and selection-score
    differences and both times; a difference is recorded, not raised."""
    import torch

    from visreps_tpu_torch.analysis import encoding

    shape = ENC_DELTA
    gen = torch.Generator(device="cuda").manual_seed(0)

    def normal(*size):
        return torch.randn(size, device="cuda", generator=gen)

    acts_tr = {f"tap{i}": normal(shape["n_train"], shape["d"]) for i in range(shape["taps"])}
    acts_te = {f"tap{i}": normal(shape["n_test"], shape["d"]) for i in range(shape["taps"])}
    y_tr, y_te = {}, {}
    for r, v in enumerate(shape["voxels"]):
        w = normal(shape["d"], v) / 64.0
        y_tr[str(r)] = acts_tr["tap3"] @ w + normal(shape["n_train"], v)
        y_te[str(r)] = acts_te["tap3"] @ w + normal(shape["n_test"], v)
    del w
    torch.cuda.synchronize()
    out = {}
    for precision in ("high", "highest"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = encoding.compute_encoding_scores_subject(
            acts_tr, acts_te, y_tr, y_te, bootstrap=False, cv_precision=precision,
            device="cuda")
        torch.cuda.synchronize()
        out[precision] = (res, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9)
    (high, high_s, high_gb), (highest, highest_s, highest_gb) = out["high"], out["highest"]
    delta = compare_encoding(high, highest)
    emit({"phase": "encoding_delta", "n_train": shape["n_train"], "n_test": shape["n_test"],
          "d": shape["d"], "taps": shape["taps"], "voxels": list(shape["voxels"]),
          "layers_high": {r: high[r][0]["layer"] for r in high},
          "layers_highest": {r: highest[r][0]["layer"] for r in highest},
          "same_layers": delta["same_layers"], "score_delta": delta["score"],
          "selection_delta": delta["selection"],
          "scores_high": {r: high[r][0]["score"] for r in high},
          "scores_highest": {r: highest[r][0]["score"] for r in highest},
          "high_s": high_s, "highest_s": highest_s, "peak_mem_gb": max(high_gb, highest_gb)})
    del acts_tr, acts_te, y_tr, y_te
    torch.cuda.empty_cache()


def check_towers() -> None:
    """CLIP and DINOv2 ViT-L/14 at full width from seeded weights
    (``load_tower(pretrained=False)``): the parameter count equal to the
    JAX tower's, a 2-image 224 px forward on the card against the CPU's
    (every tap within MODEL_TOL of its largest |value|), and the card's ms
    per image of an all-taps forward at the cross-model batch."""
    import torch

    from visreps_tpu_torch.models.hf_vit import load_tower

    x = torch.randn((2, 3, 224, 224), generator=torch.Generator().manual_seed(6))
    failures = []
    for name, n_jax in TOWER_PARAMS.items():
        model = load_tower(name, pretrained=False, device="cpu")
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
            xb = torch.randn((CROSS_MODEL["batch"], 3, 224, 224), device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(7))
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(lambda: model(xb, capture=points), 3)[0]
        worst = max(errs, key=errs.get)
        emit({"phase": "towers", "model": name, "params": n_params, "params_jax": n_jax,
              "taps": len(want), "max_rel_err": errs[worst], "worst_tap": worst,
              "tol": MODEL_TOL, "batch": CROSS_MODEL["batch"], "forward_ms": ms,
              "ms_per_image": ms / CROSS_MODEL["batch"],
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        if n_params != n_jax:
            failures.append(f"{name}: {n_params} parameters, the JAX tower has {n_jax}")
        if not errs[worst] <= MODEL_TOL:
            failures.append(f"{name}: tap {worst} on the card differs from the CPU by "
                            f"{errs[worst]} > {MODEL_TOL}")
        del model, want, got, xb
        torch.cuda.empty_cache()
    if failures:
        raise RuntimeError("; ".join(failures))


def phase_cross_model(tmp: Path) -> dict:
    """The JAX bench's stage_cross_model on the card through the port's
    ``cross_model_rdms.run``: AlexNet, ViT-B/16 and the CLIP and DINOv2
    ViT-L/14 towers from seeded random weights, every layer's RDM over 256
    synthetic images (batch 64, SRP k=4096) and the Spearman matrix of
    every model pair. Checks no model error, each model's layer count, one
    kernel launch per layer RDM (73), 10 finite matrices and each
    self-pair's diagonal within CORR_DIAG_TOL of 1. Returns the launches
    and RDM shapes for the path phase and the summary line."""
    import numpy as np
    import torch

    from visreps_tpu_torch.analysis import cross_model_rdms

    check_towers()
    spec = CROSS_MODEL
    models = spec["models"]
    with rdm_probe() as probe:
        t0 = time.perf_counter()
        payload = cross_model_rdms.run(models, f"synthetic:{spec['n_images']}",
                                       str(tmp / "cross_model_rdms.npz"), srp_k=spec["srp_k"],
                                       batch_size=spec["batch"], method=spec["method"],
                                       pretrained=False, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    corr = {k: v for k, v in payload.items() if k.startswith("corr__")}
    layers = {m: len(payload.get(f"layers__{m}", ())) for m in models}
    expected = sum(spec["layers"].values())
    diag = max((float(np.abs(np.diag(v) - 1.0).max()) for k, v in corr.items()
                if k.split("__")[1] == k.split("__")[2]), default=float("inf"))
    rec = {"phase": "cross_model", "weights": "random init (seeded)", "seconds": wall,
           "model_seconds": dict(cross_model_rdms.LAST_MODEL_TIMES), "layers": layers,
           "n_images": spec["n_images"], "batch": spec["batch"], "srp_k": spec["srp_k"],
           "rdm_launches": probe["launches"],
           "rdm_shapes": [[*k, v] for k, v in sorted(probe["shapes"].items())],
           "corr_matrices": len(corr), "self_diag_err": diag, "tol": CORR_DIAG_TOL,
           "peak_mem_gb": probe["peak_mem_gb"],
           "summary": [list(r) for r in payload["summary"]],
           "model_errors": [str(e) for e in payload.get("model_errors", ())]}
    emit(rec)
    if rec["model_errors"]:
        raise RuntimeError(f"cross_model: models failed: {rec['model_errors']}")
    if layers != spec["layers"]:
        raise RuntimeError(f"cross_model: layers {layers}, expected {spec['layers']}")
    check_launches(probe, expected, "one per layer RDM")
    n_pairs = len(models) * (len(models) + 1) // 2
    if len(corr) != n_pairs or not all(np.isfinite(v).all() for v in corr.values()):
        raise RuntimeError(f"cross_model: {len(corr)} matrices, expected {n_pairs} finite ones")
    if not diag <= CORR_DIAG_TOL:
        raise RuntimeError(f"cross_model: self-pair diagonal off 1 by {diag} > {CORR_DIAG_TOL}")
    return probe


def _rel_err(got, want) -> float:
    """max |got − want| over max |want|."""
    import numpy as np

    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


def phase_analyses(tmp: Path, data: dict) -> None:
    """The offline analyses on the card. ``extract_representations``' CLI
    on the train phase's 1,600 JPEGs (AlexNet, seed 0) in its three
    variants: SRP k=4096, ``--spatial-pool`` and exact taps. The SRP
    rows must equal the SRP of the exact taps and the pooled rows the
    H × W means of the exact post-ReLU taps (within ANALYSES["tol"] of the
    largest value). Then ``compute_eigenspectra.process_file`` on the SRP
    file against an f64 SVD of the same rows, Two-NN IDs of two layers and
    a PLSSVD cross-decomposition of conv5_post against a planted response,
    each on the card against the CPU."""
    import numpy as np
    import torch

    from visreps_tpu_torch.analysis import (compute_eigenspectra, compute_twonn_id,
                                            cross_decomposition, extract_representations)
    from visreps_tpu_torch.ops.srp import SRPTransform

    spec = ANALYSES
    common = ["--model", "AlexNet", "--dataset", "imagenet",
              "--dataset-path", data["dataset_path"], "--label-file", data["label_file"],
              "--return-nodes", *spec["nodes"], "--batch-size", str(spec["batch"]),
              "--device", "cuda"]
    feats, seconds = {}, {}
    for variant, extra in (("srp", ["--srp-k", "4096"]),
                           ("pooled", ["--srp-k", "0", "--spatial-pool"]),
                           ("exact", ["--srp-k", "0"])):
        path = tmp / f"features_{variant}.npz"
        t0 = time.perf_counter()
        if extract_representations.main([*common, *extra, "--out", str(path)]) != 0:
            raise RuntimeError(f"extract_representations ({variant}) failed")
        seconds[f"extract_{variant}_s"] = time.perf_counter() - t0
        feats[variant] = dict(np.load(path))
    ids = [list(f.pop("image_ids")) for f in feats.values()]
    if any(i != ids[0] for i in ids) or len(ids[0]) != TRAIN["n_images"]:
        raise RuntimeError("the three variants saw different images")
    srp, pooled, exact = feats["srp"], feats["pooled"], feats["exact"]
    proj = SRPTransform(k=4096, seed=0, device="cuda")
    errs = {"srp_vs_exact": max(
        _rel_err(proj(torch.from_numpy(exact[k]).cuda()).cpu().numpy(), srp[k]) for k in srp)}
    n = TRAIN["n_images"]
    conv_mean = exact["conv5_post"].reshape(n, 13, 13, 256).astype(np.float64).mean(axis=(1, 2))
    errs["pooled_vs_exact"] = max(_rel_err(pooled["conv5"], conv_mean),
                                  _rel_err(pooled["fc1"], exact["fc1_post"]))

    t0 = time.perf_counter()
    eig = np.load(compute_eigenspectra.process_file(str(tmp / "features_srp.npz"),
                                                    str(tmp / "eigenspectra"), device="cuda"))
    seconds["eigenspectra_s"] = time.perf_counter() - t0
    eig_err = 0.0
    for k, x in srp.items():
        x64 = torch.from_numpy(x).cuda().double()
        ref = (torch.linalg.svdvals(x64 - x64.mean(dim=0)) ** 2 / (n - 1)).cpu().numpy()
        eig_err = max(eig_err, _rel_err(eig[f"{k}_eigenvalues"], ref))
    errs["eigenvalues_vs_f64"] = eig_err

    ids_card, ids_cpu = {}, {}
    t0 = time.perf_counter()
    for k in ("conv5_post", "fc1_post"):
        ids_card[k] = compute_twonn_id.intrinsic_dim_layer(srp[k], device="cuda")
    seconds["twonn_s"] = time.perf_counter() - t0
    for k in ids_card:
        ids_cpu[k] = compute_twonn_id.intrinsic_dim_layer(srp[k], device="cpu")
    errs["twonn_card_vs_cpu"] = max(abs(ids_card[k][f] - ids_cpu[k][f]) / abs(ids_cpu[k][f])
                                    for k in ids_card for f in ("id", "id_half_mean"))

    rng = np.random.RandomState(0)
    acts = srp["conv5_post"]
    weights = rng.randn(acts.shape[1], spec["rank"]) @ rng.randn(spec["rank"], spec["voxels"])
    signal = acts @ weights
    neural = (signal / signal.std() + rng.randn(n, spec["voxels"])).astype(np.float32)
    t0 = time.perf_counter()
    xdec_card = cross_decomposition.compute_cross_decomposition_alignment(acts, neural,
                                                                          device="cuda")
    seconds["cross_decomposition_s"] = time.perf_counter() - t0
    xdec_cpu = cross_decomposition.compute_cross_decomposition_alignment(acts, neural,
                                                                         device="cpu")
    errs["cross_decomposition_card_vs_cpu"] = float(np.abs(
        np.subtract(xdec_card["fold_correlations"], xdec_cpu["fold_correlations"])).max())

    rec = {"phase": "analyses", "n_images": n, **seconds,
           "shapes": {v: {k: list(a.shape) for k, a in f.items()} for v, f in feats.items()},
           "effective_dim": {k: float(eig[f"{k}_effective_dim"]) for k in srp},
           "twonn_id": {k: v["id"] for k, v in ids_card.items()},
           "cross_decomposition": xdec_card["mean_cv_correlation"], **errs,
           "tol": spec["tol"], "id_tol": spec["id_tol"], "xdec_tol": spec["xdec_tol"]}
    emit(rec)
    failures = [k for k in ("srp_vs_exact", "pooled_vs_exact", "eigenvalues_vs_f64")
                if not errs[k] <= spec["tol"]]
    if not errs["twonn_card_vs_cpu"] <= spec["id_tol"]:
        failures.append("twonn_card_vs_cpu")
    if not errs["cross_decomposition_card_vs_cpu"] <= spec["xdec_tol"]:
        failures.append("cross_decomposition_card_vs_cpu")
    if failures:
        raise RuntimeError(f"analyses: {failures} out of tolerance: {errs}")


def same_pickle(a, b, path: str = "") -> list:
    """Where two preprocessed pickles differ: keys, ids, arrays (dtype,
    shape, values) and other leaves; [] when they are equal. A set of ids
    and a list of the same ids are equal (the fixture writes NSD's
    shared_ids as a list, ``preprocess_nsd`` as the set the JAX script
    writes)."""
    import numpy as np

    if isinstance(a, (set, frozenset)) or isinstance(b, (set, frozenset)):
        return [] if set(a) == set(b) else [f"{path}: ids differ"]
    if isinstance(a, dict) and isinstance(b, dict):  # key order aside, as dicts compare
        if set(a) != set(b):
            return [f"{path}: keys {sorted(a)} != {sorted(b)}"]
        return [d for k in a for d in same_pickle(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        ok = a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
        return [] if ok else [f"{path}: arrays differ"]
    return [] if a == b else [f"{path}: {a!r} != {b!r}"]


def phase_scripts(meta: dict, tmp: Path, e2e_run: dict) -> dict:
    """The data-preparation scripts on this run's fixtures: e2e's NSD
    pickle and the TVSD fixture's split into per-(region, subject) npz
    files, rebuilt by ``preprocess_nsd from-npz`` and ``preprocess_tvsd``
    (test responses as one repetition of each stimulus, so the average is
    the fixture's value) and each held equal to its fixture's pickle; then
    e2e's NSD RSA eval on the rebuilt pickle, whose rows must equal e2e's
    bit for bit, with e2e's checks (one launch per RDM)."""
    import pickle

    import numpy as np

    from visreps_tpu_torch.benchmarks import fixture
    from visreps_tpu_torch.scripts.preprocess_data import preprocess_nsd, preprocess_tvsd

    t0 = time.perf_counter()
    work = tmp / "scripts"
    nsd_npz, tvsd_npz, nsd_out = work / "nsd_npz", work / "tvsd_npz", work / "nsd"
    for d in (nsd_npz, tvsd_npz, nsd_out):
        d.mkdir(parents=True)
    with open(meta["pickle"], "rb") as f:
        nsd = pickle.load(f)
    for region, by_subj in nsd["data"].items():
        for subj, r in by_subj.items():
            np.savez(nsd_npz / f"{region}_subj{subj}.npz", stimulus=np.asarray(r["stimulus"]),
                     values=r["values"])
    np.save(work / "shared_ids.npy", np.asarray(nsd["shared_ids"], np.int64))
    preprocess_nsd.main(["from-npz", "--npz-dir", str(nsd_npz), "--shared-ids",
                         str(work / "shared_ids.npy"), "--out", str(nsd_out / "nsd_data.pkl")])
    with open(nsd_out / "nsd_data.pkl", "rb") as f:
        nsd_diff = same_pickle(pickle.load(f), nsd)

    t1 = time.perf_counter()
    tvsd_meta = fixture.ensure_tvsd_fixture(tmp / "fixture", **TVSD)  # tvsd's, when it ran
    tvsd_fixture_s = time.perf_counter() - t1
    tvsd_pkl = Path(tvsd_meta["root"]) / "datasets" / "neural" / "tvsd" / "fmri_responses.pkl"
    with open(tvsd_pkl, "rb") as f:
        tvsd = pickle.load(f)
    for region, by_subj in tvsd.items():
        for subj, r in by_subj.items():
            np.savez(tvsd_npz / f"{region}_subj{subj}.npz",
                     train_stimulus=np.asarray(r["train"]["stimulus"]),
                     train_values=r["train"]["values"],
                     test_stimulus=np.asarray(r["test"]["stimulus"]),
                     test_values=r["test"]["values"][:, None, :])
    preprocess_tvsd.main(["--npz-dir", str(tvsd_npz), "--out", str(work / "tvsd" / "resp.pkl")])
    with open(work / "tvsd" / "resp.pkl", "rb") as f:
        tvsd_diff = same_pickle(pickle.load(f), tvsd)
    scripts_s = time.perf_counter() - t0 - tvsd_fixture_s
    if nsd_diff or tvsd_diff:
        raise RuntimeError(f"rebuilt pickles differ: NSD {nsd_diff[:5]}, TVSD {tvsd_diff[:5]}")

    with environ(NSD_DATA_DIR=nsd_out):
        run = run_eval("scripts_e2e", meta, E2E_SOURCE, E2E_ROWS,
                       lambda cfg_id, epoch: epoch == -1,
                       extra={"scripts_s": scripts_s, "tvsd_fixture_s": tvsd_fixture_s})
    want = [(r["layer"], r["score"], r["ci_low"], r["ci_high"]) for r in e2e_run["results"]]
    got = [(r["layer"], r["score"], r["ci_low"], r["ci_high"]) for r in run["results"]]
    if got != want:
        raise RuntimeError(f"the eval on the rebuilt pickle {got} != e2e's {want}")
    return run


def phase_parallel(meta: dict, tmp: Path, e2e_run: dict) -> dict:
    """``parallel/`` on NCCL at world size 1 (one card: NCCL refuses two
    ranks on one device), the group made through a FileStore in the
    temporary directory:

      * ``rdm_sharded`` at PARALLEL's (n, d) f32 against ``compute_rdm``
        (the kernel, one launch) at ``tolerance(d)``, each timed with
        CUDA events;
      * the sharded bootstrap route (``shard_iterations``: pad, this
        rank's slice, all-gather) against the unsharded call at e2e's
        shapes, bit for bit;
      * one data-parallel train step (``sync_batch_norm`` over the group,
        the gradients all-reduced) of CustomCNN against the plain step
        from the same weights (SGD, dropout on: loss, gradient norm and
        ``tests/test_sharding.py``'s tolerances for the JAX package's
        sharded step: loss 1e-5 and gradient norm 1e-3 relative,
        parameters 3e-3 and BatchNorm statistics 1e-5 absolute. cuDNN's
        batch norm and the global-batch path sum the statistics in other
        orders, and a pre-activation within that roundoff of 0 flips its
        ReLU, which moves single gradient entries by up to ≈ 1e-3 of the
        tensor's largest, as in ``tests/test_torch_port_train_families.py``'s
        ResNet50 case);
      * e2e's eval through ``evals.eval`` with a one-rank mesh and
        ``rdm_shard_threshold`` below its 1,000 test stimuli, so its phase-2
        RDMs take the ring and its batches ``extract_sharded_batch``: the
        same layers as e2e, S·(T + R) + P kernel launches (the ring launches
        none), scores and CIs within PARALLEL's score_tol of e2e's: the
        ring's f32 product and the kernel's 3xTF32 RDMs part by ≈ 1e-6,
        about the gap between neighbouring sorted entries of a crowded
        tap's 499,500, so near-tied entries exchange ranks; each exchange
        moves a Spearman score by at most 12 / (M (M + 1)) = 4.8e-11."""
    from datetime import timedelta

    import numpy as np
    import torch
    import torch.distributed as dist

    from visreps_tpu_torch.core.config import Config, load_config
    from visreps_tpu_torch.evals import eval as run_evals
    from visreps_tpu_torch.models.custom_cnn import CustomCNN
    from visreps_tpu_torch.models.layers import sync_batch_norm
    from visreps_tpu_torch.ops import rdm_kernel
    from visreps_tpu_torch.ops.bootstrap import bootstrap_indices, grouped_core
    from visreps_tpu_torch.ops.rdm import compute_rdm, triu_indices
    from visreps_tpu_torch.parallel import make_mesh, rdm_sharded
    from visreps_tpu_torch.parallel.shard import shard_iterations
    from visreps_tpu_torch.run import validate_config
    from visreps_tpu_torch.train.optim import Optimizer
    from visreps_tpu_torch.train.trainer import train_step

    spec = PARALLEL
    t_phase = time.perf_counter()
    store = dist.FileStore(str(tmp / "nccl_store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=timedelta(seconds=300))
    rec = {"phase": "parallel", "backend": dist.get_backend(), "world_size": 1}
    try:
        mesh = make_mesh(data=1)
        group = mesh.get_group("data")

        n, d = spec["n"], spec["d"]
        gen = torch.Generator(device="cuda").manual_seed(spec["seed"])
        x = torch.randn((n, 64), device="cuda", generator=gen) @ torch.randn(
            (64, d), device="cuda", generator=gen) + torch.randn((n, d), device="cuda",
                                                                 generator=gen)
        rdm_kernel.LAUNCHES = 0
        kernel = compute_rdm(x)
        if rdm_kernel.LAUNCHES != 1:
            raise RuntimeError(f"compute_rdm made {rdm_kernel.LAUNCHES} launches, expected 1")
        ring = rdm_sharded(x, mesh)
        err = float((ring - kernel).abs().max())
        iters = timing_iters(n, d)
        rec["rdm"] = {"n": n, "d": d, "max_abs_err": err, "tol": tolerance(d, "float32"),
                      "ring_ms": time_ms(lambda: rdm_sharded(x, mesh), iters)[0],
                      "kernel_ms": time_ms(lambda: compute_rdm(x), iters)[0]}
        del x, ring, kernel

        m, v = spec["boot_n"], 512
        iu, ju = triu_indices(m, "cuda")
        model_tris = compute_rdm(torch.randn((m, 4096), device="cuda", generator=gen))[iu, ju][None]
        neural_tris = compute_rdm(torch.randn((m, v), device="cuda", generator=gen))[iu, ju][None]
        idx = torch.as_tensor(bootstrap_indices(m, spec["n_boot"], seed=42), device="cuda")
        plain, _ = grouped_core(model_tris, neural_tris, [0], idx, m)
        sharded = shard_iterations(lambda ix: grouped_core(model_tris, neural_tris, [0], ix, m)[0],
                                   idx, mesh)
        rec["bootstrap_equal"] = bool(torch.equal(plain, sharded))

        states, steps, param_names = [], [], set()
        bx = torch.randn((spec["dp_batch"], 3, 224, 224), device="cuda", generator=gen)
        by = torch.randint(0, 1000, (spec["dp_batch"],), device="cuda", generator=gen)
        start = {k: v.clone() for k, v in CustomCNN(num_classes=1000).state_dict().items()}
        for dp in (False, True):
            model = CustomCNN(num_classes=1000)
            model.load_state_dict(start)
            model.cuda()
            if dp:
                sync_batch_norm(model, group)
            opt = Optimizer(model, Config({"optimizer": "sgd", "learning_rate": 0.1,
                                           "num_epochs": 2, "warmup_epochs": 0,
                                           "grad_clip": 0}), 1, model.trainable_mask())
            rows = (0, spec["dp_batch"]) if dp else None
            loss, gn = train_step(model, opt, bx, by, torch.Generator(device="cuda").manual_seed(0),
                                  0, group=group if dp else None, rows=rows)
            steps.append((float(loss), float(gn)))
            states.append(model.state_dict())
            param_names = {k for k, _ in model.named_parameters()}
        gaps = {k: float((states[1][k].float() - v.float()).abs().max())
                for k, v in states[0].items() if v.is_floating_point()}
        rec["dp_step"] = {"loss": steps,
                          "param_err": max(v for k, v in gaps.items() if k in param_names),
                          "stats_err": max(v for k, v in gaps.items() if k not in param_names),
                          "tols": spec["dp_tols"]}
        del states

        cfg = validate_config(load_config(str(ROOT / "configs/eval/base.json"), [
            *rsa_overrides(E2E_SOURCE, list(range(E2E["n_subjects"])),
                           NSD_REGIONS[:E2E["n_regions"]]),
            f"rdm_shard_threshold={spec['threshold']}", "log_expdata=false", "mode=eval"]))
        with rdm_probe() as probe:
            t0 = time.perf_counter()
            results = run_evals(cfg, device="cuda", mesh=mesh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    pairs = E2E["n_subjects"] * E2E["n_regions"]
    check_rsa_results(results, pairs, 14)
    run = {"results": results, "launches": probe["launches"], "shapes": probe["shapes"]}
    check_launches(run, E2E["n_subjects"] * (14 + E2E["n_regions"]) + pairs,
                   "S·(T + R) + P: phase 2's RDMs take the ring")
    score_gap = max(abs(a[k] - b[k]) for a, b in zip(results, e2e_run["results"])
                    for k in ("score", "ci_low", "ci_high"))
    rec.update({"eval_s": wall, "eval_launches": probe["launches"], "score_gap": score_gap,
                "score_tol": spec["score_tol"],
                "layers": [r["layer"] for r in results], "seconds": time.perf_counter() - t_phase})
    emit(rec)
    problems = []
    if not rec["rdm"]["max_abs_err"] <= rec["rdm"]["tol"]:
        problems.append("rdm_sharded vs the kernel")
    if not rec["bootstrap_equal"]:
        problems.append("sharded bootstrap")
    (l0, g0), (l1, g1) = steps
    tols = spec["dp_tols"]
    if not (abs(l1 - l0) <= tols["loss_rtol"] * abs(l0)
            and abs(g1 - g0) <= tols["grad_norm_rtol"] * g0
            and rec["dp_step"]["param_err"] <= tols["param_atol"]
            and rec["dp_step"]["stats_err"] <= tols["stats_atol"]):
        problems.append("data-parallel step")
    if rec["layers"] != [r["layer"] for r in e2e_run["results"]]:
        problems.append("mesh eval layers")
    if not score_gap <= spec["score_tol"]:
        problems.append("mesh eval scores")
    if problems:
        raise RuntimeError(f"parallel: {problems}: {rec}")
    return run


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
    folds = ridge._Folds(y, 5)
    sweep_ms = {p: time_ms(lambda: ridge._wood_cv_scores(x, folds, lam, v_eig, c, alphas, p), 1)[0]
                for p in ("high", "highest")}
    tf32_ops, f32_ops = wood_cv_ops(7200, 4096, 15208)
    del y, folds, lam, v_eig, c
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


def phase_encoding(tmp: Path) -> dict:
    """The encoding-score eval through ``run.main`` on its own NSD-count
    fixture; checks results, rows, scores, devices and route. Returns the
    results and the first subject's inputs to the encoding functions."""
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
        store["first_subject"] = next(iter(subject_inputs.values()))
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
                            "FROM results WHERE analysis = 'encoding_score' "
                            "AND model_name = 'AlexNet'").fetchall()
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
          "store": {k: sorted(store[k]) for k in ("devices", "dtypes")},
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
    torch.cuda.empty_cache()
    emit({"phase": "encoding_linalg", **time_linalg()})
    return {"results": results, "inputs": store["first_subject"], "regions": regions}


def phase_encoding_sharded(tmp: Path, enc: dict) -> None:
    """The encoding phase's first subject (9,000 train and 1,000 test rows,
    2 regions × 7,604 voxels, 14 taps at SRP k = 4096) through
    ``compute_encoding_scores_subjects(..., mesh=)``, the row-sharded route,
    on a one-rank NCCL group (a FileStore in ``tmp``): every collective of
    ``parallel.shard.RowBlocks`` (sums, gathers by row index, broadcasts)
    runs on the card at world size 1. Holds layers, scores, CIs and
    selection scores to the encoding phase's rows within ENC_TOL; every
    ridge tensor on the card; no RDM launch. Prints the encoding module's
    sub-phase seconds, the peak memory, the collective calls and the
    largest differences."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from visreps_tpu_torch.analysis import encoding
    from visreps_tpu_torch.ops import rdm_kernel, ridge
    from visreps_tpu_torch.parallel import make_mesh
    from visreps_tpu_torch.parallel.shard import RowBlocks

    regions = enc["regions"]
    calls, tensor_devices = Counter(), set()
    originals = {name: getattr(ridge, name) for name in ("_wood_cv_scores", "_ridge_cv_impl",
                                                          "_gram")}
    collectives = {name: getattr(RowBlocks, name) for name in ("sum", "gather", "share")}

    def probe(name, fn, devices):
        def call(*args, **kwargs):
            calls[name] += 1
            if devices:  # (a gather's row positions are a host index)
                tensor_devices.update(a.device.type for a in args if isinstance(a, torch.Tensor))
            return fn(*args, **kwargs)
        return call

    t_phase = time.perf_counter()
    store = dist.FileStore(str(tmp / "nccl_store_encoding"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=timedelta(seconds=300))
    for name, fn in originals.items():
        setattr(ridge, name, probe(name, fn, True))
    for name, fn in collectives.items():
        setattr(RowBlocks, name, probe(name, fn, False))
    try:
        mesh = make_mesh(data=1)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rdm_kernel.LAUNCHES = 0
        t0 = time.perf_counter()
        out = encoding.compute_encoding_scores_subjects(
            {0: enc["inputs"]}, bootstrap=True, n_bootstrap=1000, cv_precision="high",
            device="cuda", mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rdm_launches = rdm_kernel.LAUNCHES
    finally:
        for name, fn in originals.items():
            setattr(ridge, name, fn)
        for name, fn in collectives.items():
            setattr(RowBlocks, name, fn)
        dist.destroy_process_group()
    peak = torch.cuda.max_memory_allocated() / 1e9
    ref = {r: [enc["results"][i]] for i, r in enumerate(regions)}  # subject 0's rows
    diff = compare_encoding(out[0], ref)
    problems = []
    if not diff["same_layers"]:
        problems.append(f"layers {diff['layers']} against {[ref[r][0]['layer'] for r in regions]}")
    if not max(diff["score"], diff["ci_low"], diff["ci_high"], diff["selection"]) <= ENC_TOL:
        problems.append(f"scores, CIs or selection scores beyond {ENC_TOL}")
    if tensor_devices != {"cuda"}:
        problems.append(f"ridge tensors on {sorted(tensor_devices)}")
    if not all(calls[name] for name in collectives):
        problems.append(f"a RowBlocks collective never ran: {dict(calls)}")
    if calls["_ridge_cv_impl"]:
        problems.append("the per-fold-eigh route ran")
    if rdm_launches:
        problems.append(f"the encoding route launched the RDM kernel {rdm_launches} times")
    emit({"phase": "encoding_sharded", "seconds": wall, "wall_s": time.perf_counter() - t_phase,
          "backend": "nccl", "world_size": 1, "subject": 0, "regions": len(regions),
          "phase_times_s": dict(encoding.LAST_PHASE_TIMES), "peak_mem_gb": peak,
          "calls": dict(calls), "ridge_tensor_devices": sorted(tensor_devices),
          "rdm_launches": rdm_launches, "max_diff": diff, "tol": ENC_TOL,
          "problems": problems})
    if problems:
        raise RuntimeError(f"encoding_sharded: {problems}")


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
    """Per-region layers and the largest |difference| of scores, CIs (None
    without a bootstrap) and selection scores between two
    compute_encoding_scores_subject outputs."""
    out = {"same_layers": all(got[r][0]["layer"] == ref[r][0]["layer"] for r in ref)}
    for key in ("score", "ci_low", "ci_high"):
        diffs = [abs(got[r][0][key] - ref[r][0][key]) for r in ref if ref[r][0][key] is not None]
        out[key] = max(diffs, default=None)
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


@contextmanager
def environ(**values):
    """Set environment variables for the block; restore them after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def timed(fn, *args, **kwargs):
    """(fn's result, seconds), the card synchronised at the end."""
    import torch

    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def nsd_env(meta: dict) -> dict:
    """The environment that points the NSD loaders at ``meta``'s fixture
    (later phases point them at their own)."""
    return {"NSD_DATA_DIR": Path(meta["pickle"]).parent, "NSD_STIMULI_HDF5": meta["stimuli"]}


def first_images(n: int):
    """The first ``n`` images of the ImageNet the environment names, in the
    extraction scripts' order and transform."""
    from visreps_tpu_torch.scripts.extract_representations.utils import iterate_imagenet

    loader, _ = iterate_imagenet(batch_size=n)
    return next(iter(loader))[0]


def card_vs_cpu(name: str, card_rows, build, images) -> dict:
    """Max |card − CPU| over the CPU's largest |value| for the first rows:
    ``build(device)`` makes the extraction function on that device."""
    import torch

    want = torch.as_tensor(build(torch.device("cpu"))(images)).float()
    got = torch.as_tensor(card_rows[:len(images)]).float()
    err = ((got - want).abs().max() / want.abs().max()).item()
    if not err <= MODEL_TOL:
        raise RuntimeError(f"{name}: card features differ from the CPU's by {err} > {MODEL_TOL}")
    return {"card_vs_cpu_rel_err": err, "tol": MODEL_TOL, "rows_checked": len(images)}


def f64_fit(features, k: int):
    """Top-k eigenvalues and eigenvectors of the features' covariance in
    float64 on the CPU, and the total variance."""
    import numpy as np
    import torch

    x = torch.from_numpy(features).to(torch.float64)
    xc = x - x.mean(dim=0)
    vals, vecs = torch.linalg.eigh(xc.T @ xc / x.shape[0])
    order = torch.argsort(vals, descending=True)[:k]
    return vals[order].numpy(), vecs[:, order].numpy(), float(vals.sum())


def label_checks(features, eig, card_dir: Path, cpu_dir: Path) -> dict:
    """The card's CSVs against the CPU's from the same files: nested
    labels, each bit split at its median, and card = CPU except rows
    whose projection lies within the card-vs-CPU roundoff of the median."""
    import numpy as np

    from visreps_tpu_torch.scripts.coarsegrain.make_pca_labels import np_median, project

    bits = COARSEGRAIN["max_bits"]
    read = {d: {b: np.loadtxt(d / f"n_classes_{2 ** b}.csv", delimiter=",", skiprows=1,
                              usecols=1, dtype=np.int64) for b in range(1, bits + 1)}
            for d in (card_dir, cpu_dir)}
    card, cpu = read[card_dir], read[cpu_dir]
    n = len(features)
    for b in range(2, bits + 1):
        if not np.array_equal(card[b] >> 1, card[b - 1]):
            raise RuntimeError(f"{2 ** b}-class labels are not nested in the {2 ** (b - 1)}")
    ones = [int(((card[bits] >> (bits - 1 - j)) & 1).sum()) for j in range(bits)]
    if ones != [n // 2] * bits:
        raise RuntimeError(f"bits above their medians: {ones}, expected {n // 2} each")
    p_card = project(features, eig["eigenvectors"], eig["mean"], bits, "cuda").cpu()
    p_cpu = project(features, eig["eigenvectors"], eig["mean"], bits, "cpu")
    m_card, m_cpu = np_median(p_card), np_median(p_cpu)
    differ = np.nonzero(card[bits] != cpu[bits])[0]
    for row in differ:
        flipped = ((card[bits][row] ^ cpu[bits][row]) >> np.arange(bits)[::-1]) & 1
        for j in np.nonzero(flipped)[0]:
            gap = abs(float(p_cpu[row, j] - m_cpu[j]))
            roundoff = (abs(float(p_cpu[row, j] - p_card[row, j]))
                        + abs(float(m_cpu[j] - m_card[j])))
            if gap > roundoff:
                raise RuntimeError(f"row {row}, PC {j}: card and CPU labels differ {gap} from "
                                   f"the median, beyond their roundoff {roundoff}")
    return {"rows": n, "ones_per_bit": ones, "card_cpu_differing_rows": len(differ),
            "projection_card_vs_cpu_max": float((p_card - p_cpu).abs().max()),
            "class_counts_64": np.bincount(card[bits], minlength=2 ** bits).tolist()}


def phase_coarsegrain(meta: dict, tmp: Path) -> dict:
    """The PCA-label pipeline at full width: AlexNet ``fc2_post`` features of
    a synthetic ImageNet (COARSEGRAIN["n_images"] JPEGs, seeded IMAGENET1K-
    layout weights), the top-k PCs on the card, 2–64-class labels, CustomCNN
    trained on the 64-class CSV through ``run.main``, and that checkpoint's
    NSD RSA eval; then ViT-B, CLIP-L/14 and DINOv2-L/14 extraction on a
    second tree of COARSEGRAIN["tower_images"]. Returns the eval's run, the
    checkpoint directory and the ImageNet overrides for cg_benefits."""
    import numpy as np
    import torch

    from visreps_tpu_torch import run
    from visreps_tpu_torch.benchmarks.fixture import write_imagenet_fixture
    from visreps_tpu_torch.benchmarks.weights import write_torchvision_weights
    from visreps_tpu_torch.models.hf_vit import load_tower
    from visreps_tpu_torch.models.torch_import import load_pretrained_torch
    from visreps_tpu_torch.models.zoo import init_model
    from visreps_tpu_torch.scripts.coarsegrain import compute_eigenvectors, make_pca_labels
    from visreps_tpu_torch.scripts.extract_representations import (
        alexnet_representations, clip_representations, dino_representations,
        vit_representations)
    from visreps_tpu_torch.scripts.extract_representations.utils import extract_and_save

    spec = COARSEGRAIN
    root = tmp / "coarsegrain"
    rec = {"phase": "coarsegrain", "n_images": spec["n_images"]}
    t_phase = t0 = time.perf_counter()
    data = write_imagenet_fixture(root / "imagenet", spec["n_images"], pca_n_classes=[])
    towers = write_imagenet_fixture(root / "towers", spec["tower_images"], pca_n_classes=[])
    for name, seed in (("AlexNet", spec["alexnet_seed"]), ("ViTBase", spec["vit_seed"])):
        write_torchvision_weights(root / "weights", name, seed=seed)
    rec["fixture_s"] = time.perf_counter() - t0
    env = {"IMAGENET_DATA_DIR": data["dataset_path"],
           "IMAGENET_LOCAL_DIR": Path(data["label_file"]).parent,
           "TORCH_WEIGHTS_DIR": root / "weights"}
    feats_path, eig_path = root / "features_alexnet.npz", root / "eigenvectors_alexnet.npz"
    card_dir, cpu_dir = root / "pca_labels_card", root / "pca_labels_cpu"
    seconds = {}
    torch.cuda.reset_peak_memory_stats()
    with environ(**env):
        _, seconds["extract"] = timed(alexnet_representations.main,
                                      ["--out", str(feats_path), "--batch-size", "256"])
        feats = np.load(feats_path)
        features = feats["features"]
        if features.shape != (spec["n_images"], 4096) or not np.isfinite(features).all():
            raise RuntimeError(f"AlexNet features {features.shape}, finite "
                               f"{np.isfinite(features).all()}")

        def alexnet_on(device):
            model = load_pretrained_torch(init_model("AlexNet", 1000, seed=0, device=device),
                                          "AlexNet", 1000)
            return alexnet_representations.build_extract(model, device)

        rec["alexnet"] = card_vs_cpu("alexnet", features, alexnet_on,
                                     first_images(spec["check_rows"]))
    rec["extract_images_per_s"] = spec["n_images"] / seconds["extract"]

    _, seconds["fit"] = timed(compute_eigenvectors.main, [
        "--features", str(feats_path), "--out", str(eig_path), "--top-k", str(spec["top_k"])])
    eig = np.load(eig_path)
    t0 = time.perf_counter()
    vals64, vecs64, total64 = f64_fit(features, spec["top_k"])
    rec["f64_fit_s"] = time.perf_counter() - t0
    eig_err = np.abs(eig["eigenvalues"] - vals64) / vals64
    cosines = np.linalg.svd(vecs64.T @ eig["eigenvectors"].astype(np.float64), compute_uv=False)
    angle = float(np.arccos(np.clip(cosines.min(), -1.0, 1.0)))
    rec["pca"] = {"eigenvalues": eig["eigenvalues"].tolist(),
                  "eigenvalue_rel_err_max": float(eig_err.max()),
                  "total_variance_rel_err": abs(float(eig["total_variance"]) - total64) / total64,
                  "subspace_angle_rad": angle, "eig_rtol": spec["eig_rtol"],
                  "angle_tol_rad": spec["angle_tol"],
                  "variance_ratio": (eig["eigenvalues"] / eig["total_variance"]).tolist()}
    if not (eig_err.max() <= spec["eig_rtol"] and angle <= spec["angle_tol"]):
        raise RuntimeError(f"card PCA against the f64 fit: {rec['pca']}")

    label_args = ["--features", str(feats_path), "--eigen", str(eig_path),
                  "--max-bits", str(spec["max_bits"])]
    _, seconds["labels"] = timed(make_pca_labels.main, [*label_args, "--out-dir", str(card_dir)])
    make_pca_labels.main([*label_args, "--out-dir", str(cpu_dir), "--device", "cpu"])
    rec["labels"] = label_checks(features, eig, card_dir, cpu_dir)
    del features, feats

    checkpoint_dir = root / "model_checkpoints"
    n_classes = 2 ** spec["max_bits"]
    trainer, seconds["train"] = timed(run.main, [
        "--mode", "train", "--config", str(ROOT / "configs/train/base.json"), "--override",
        "pca_labels=true", f"pca_n_classes={n_classes}", f"batchsize={spec['batch']}",
        "num_epochs=1", "warmup_epochs=0", f"train_fraction={spec['train_fraction']}",
        "num_workers=16", "log_interval=2", "checkpoint_interval=1", "log_checkpoints=true",
        f"checkpoint_dir={checkpoint_dir}", f"dataset_path={data['dataset_path']}",
        f"label_file={data['label_file']}", f"pca_labels_folder={card_dir}"])
    losses = [h["loss"] for h in trainer.history]
    if len(losses) != spec["train_steps"] or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"train on the PCA labels: {len(losses)} steps, losses {losses}")
    run_dir = checkpoint_dir / f"cfg{n_classes}a"
    for epoch in (0, 1):
        if not (run_dir / f"checkpoint_epoch_{epoch}.pth").is_file():
            raise RuntimeError(f"train did not write epoch {epoch}'s checkpoint in {run_dir}")
    rec["train"] = {"steps": len(losses), "loss": losses, "batch": spec["batch"],
                    "ms_per_step_in_trainer": 1e3 * seconds["train"] / len(losses),
                    "loader_wait_s": trainer.loader_wait_s}
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

    t0 = time.perf_counter()
    with environ(**nsd_env(meta)):
        eval_run = run_eval("coarsegrain_eval", meta, [
            "load_model_from=checkpoint", f"cfg_id={n_classes}",
            f"checkpoint_dir={checkpoint_dir}", "checkpoint_model=checkpoint_epoch_1.pth"],
            f"cfg_id = {n_classes} AND epoch = 1",
            lambda cfg_id, epoch: cfg_id == n_classes and epoch == 1)
    seconds["eval"] = time.perf_counter() - t0

    tower_env = {"IMAGENET_DATA_DIR": towers["dataset_path"],
                 "IMAGENET_LOCAL_DIR": Path(towers["label_file"]).parent,
                 "TORCH_WEIGHTS_DIR": root / "weights"}
    rec["towers"] = {}
    with environ(**tower_env):
        images = first_images(spec["tower_check_rows"])

        def vit_on(device):
            model = load_pretrained_torch(init_model("ViTBase", 1000, seed=0, device=device),
                                          "ViTBase", 1000)
            return vit_representations.build_extract(model, device)

        def tower_on(kind):
            """One seeded tower, built once on the CPU (a ViT-L init takes
            seconds) and moved to the device each extraction asks for."""
            module = clip_representations if kind == "clip-vit-l14" else dino_representations
            tower = load_tower(kind, pretrained=False, device="cpu")

            def build(device):
                tower.to(device)
                return (module.build_extract(tower, 224, device) if module is clip_representations
                        else module.build_extract(tower, device))
            return build

        for name, build in (("vit_b16", vit_on), ("clip-vit-l14", tower_on("clip-vit-l14")),
                            ("dinov2-l14", tower_on("dinov2-l14"))):
            out = root / f"features_{name}.npz"
            torch.cuda.reset_peak_memory_stats()
            if name == "vit_b16":
                _, s = timed(vit_representations.main, ["--backend", "flax", "--out", str(out)])
            else:
                _, s = timed(extract_and_save, build(torch.device("cuda")), str(out),
                             batch_size=128)
            rows = np.load(out)["features"]
            if len(rows) != spec["tower_images"] or not np.isfinite(rows).all():
                raise RuntimeError(f"{name}: {rows.shape} features, finite {np.isfinite(rows).all()}")
            rec["towers"][name] = {"seconds": s, "images_per_s": len(rows) / s,
                                   "dim": rows.shape[1],
                                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                                   **card_vs_cpu(name, rows, build, images)}
            torch.cuda.empty_cache()
    rec["seconds"] = seconds
    rec["rdm_launches"] = eval_run["launches"]
    rec["wall_s"] = time.perf_counter() - t_phase
    emit(rec)
    return {"eval": eval_run, "checkpoint_dir": checkpoint_dir, "imagenet": data,
            "n_classes": n_classes, "eigenvectors": eig_path, "features": feats_path,
            "labels_dir": card_dir, "towers": towers}


def phase_cg_benefits(meta: dict, tmp: Path, cg: dict) -> dict:
    """The coarse-grain-benefit experiments on the coarsegrain phase's
    checkpoint (CLI entry points, on the card): linear probe, few-shot,
    class selectivity and augmentation invariance on a seeded Tiny-ImageNet
    tree; ImageNet-C robustness (all 15 corruptions) with the torch
    logistic probe, and the deterministic corruptions card against CPU;
    curriculum fine-tuning 64 → 1000 (late_layers); curriculum NSD RSA of
    three checkpoints on the e2e fixture, one RDM launch per RDM. Returns
    the RSA run (launches and RDM shapes)."""
    import numpy as np
    import torch

    from visreps_tpu_torch.benchmarks.fixture import write_tiny_imagenet_fixture
    from visreps_tpu_torch.experiments.coarse_grain_benefits import (
        augmentation_invariance, class_selectivity, corruptions, curriculum_finetuning,
        curriculum_nsd_rsa, few_shot, imagenet_c_robustness, linear_probe)

    spec = CG_BENEFITS
    root = tmp / "cg_benefits"
    rec = {"phase": "cg_benefits"}
    t_phase = t0 = time.perf_counter()
    tiny = write_tiny_imagenet_fixture(root / "tiny", n_classes=spec["classes"],
                                       n_train=spec["n_train"], n_val=spec["n_val"])
    rec["fixture_s"] = time.perf_counter() - t0
    n_classes = cg["n_classes"]
    chance = 100.0 / spec["classes"]
    ckpt = Path(cg["checkpoint_dir"]) / f"cfg{n_classes}a"
    common = ["--checkpoint-dir", str(cg["checkpoint_dir"]), "--cfg-id", str(n_classes),
              "--checkpoint-model", "checkpoint_epoch_1.pth", "--probe-dataset", tiny]
    seconds = {}
    torch.cuda.reset_peak_memory_stats()
    top1, seconds["linear_probe"] = timed(linear_probe.main, common)
    shots, seconds["few_shot"] = timed(few_shot.main, [*common, "--k-shot", *map(str, spec["k_shot"]),
                                                       "--episodes", str(spec["episodes"])])
    sel, seconds["class_selectivity"] = timed(class_selectivity.main, common)
    inv, seconds["augmentation_invariance"] = timed(augmentation_invariance.main, common)
    # The linear probe is held to finite only: its ridge CV (both packages')
    # takes contiguous folds of the class-sorted rows, so each fold holds out
    # whole classes and CV picks the largest alpha for every class.
    rec["linear_probe_top1"] = top1
    rec["chance_pct"] = chance
    rec["few_shot"] = {str(k): list(v) for k, v in shots.items()}
    rec["class_selectivity"] = {k: {"mean": float(v.mean()), "units": len(v)}
                                for k, v in sel.items()}
    rec["augmentation_invariance"] = {k: float(v.mean()) for k, v in inv.items()}
    if not (math.isfinite(top1)
            and all(math.isfinite(m) and m > chance for m, _ in shots.values())
            and inv and all(np.isfinite(v).all() for v in (*sel.values(), *inv.values()))):
        raise RuntimeError(f"probe accuracies not finite or not above chance ({chance} %): {rec}")

    imc_csv = root / "imagenet_c_robustness.csv"
    rows, seconds["imagenet_c"] = timed(imagenet_c_robustness.main, [
        "--checkpoints", f"{n_classes}way={ckpt / 'checkpoint_epoch_1.pth'}",
        "--probe-dataset", f"{tiny}/train", "--n-images", str(spec["imc_images"]),
        "--severity", "3", "--image-size", "224", "--out", str(imc_csv)])
    clean = rows[0]["clean_acc"]
    if (len(rows) != 15 or not 100.0 * clean > chance
            or not all(0.0 <= r["corrupt_acc"] <= 1.0 for r in rows)):
        raise RuntimeError(f"imagenet_c: {len(rows)} rows, clean accuracy {clean}")
    rec["imagenet_c"] = {"clean_acc": clean,
                         "corrupt_acc": {r["corruption"]: r["corrupt_acc"] for r in rows}}
    images, _ = imagenet_c_robustness.load_images(f"{tiny}/train", spec["corrupt_check"], 224)
    images = images[:spec["corrupt_check"]]
    rec["corruptions"] = {}
    for name in corruptions.CORRUPTIONS:
        out, s = timed(corruptions.corrupt_batch, name, images, 3, 42, "cuda")
        entry = {"ms": 1e3 * s}
        if name in spec["deterministic"]:
            want = corruptions.corrupt_batch(name, images, 3, 42, "cpu")
            entry["card_vs_cpu_max_abs"] = float((out.cpu() - want).abs().max())
            if not entry["card_vs_cpu_max_abs"] <= spec["corrupt_tol"]:
                raise RuntimeError(f"{name}: card against CPU {entry}")
        rec["corruptions"][name] = entry

    out_dir = root / "curriculum_checkpoints"
    with environ(IMAGENET_DATA_DIR=cg["towers"]["dataset_path"],
                 IMAGENET_LOCAL_DIR=Path(cg["towers"]["label_file"]).parent):
        results, seconds["curriculum_finetuning"] = timed(curriculum_finetuning.main, [
            "--source-cfg-id", str(n_classes), "--target-cfg-id", "1000",
            "--checkpoint-dir", str(cg["checkpoint_dir"]),
            "--checkpoint-model", "checkpoint_epoch_1.pth", "--transfer-mode", "late_layers",
            "--num-epochs", "1", "--warmup-epochs", "0", "--eval-freq", "1",
            "--batch-size", str(spec["finetune_batch"]), "--num-workers", "16",
            "--output-dir", str(out_dir)])
    finetuned = out_dir / f"cfg{n_classes}_to_1000_late_layers_a"
    if not (len(results) == 2 and all(math.isfinite(r["val_top1"]) for r in results)
            and (finetuned / "checkpoint_epoch_1.pth").is_file()):
        raise RuntimeError(f"curriculum_finetuning: {results}")
    rec["curriculum_finetuning"] = {"val_top1": [r["val_top1"] for r in results],
                                    "train_loss": results[-1]["train_loss"]}

    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    checkpoints = {f"{n_classes}way": ckpt / "checkpoint_epoch_1.pth",
                   f"{n_classes}to1000": finetuned / "checkpoint_epoch_1.pth",
                   "untrained": ckpt / "checkpoint_epoch_0.pth"}
    subjects = list(range(E2E["n_subjects"]))
    with environ(**nsd_env(meta)), rdm_probe() as probe:
        t0 = time.perf_counter()
        rsa_rows = curriculum_nsd_rsa.main([
            "--checkpoints", *(f"{k}={v}" for k, v in checkpoints.items()),
            "--subjects", *map(str, subjects), "--out-dir", str(root / "rsa")])
        torch.cuda.synchronize()
        seconds["curriculum_nsd_rsa"] = time.perf_counter() - t0
    n_layers = len(curriculum_nsd_rsa.LAYERS)
    n_regions = len(curriculum_nsd_rsa.REGIONS)
    expected_rows = len(checkpoints) * len(subjects) * n_regions * n_layers
    keys = {(r["model_name"], r["subject_idx"], r["region"], r["layer"]) for r in rsa_rows}
    expected_rdms = len(checkpoints) * len(subjects) * n_regions * (n_layers + 1)
    if (len(rsa_rows) != expected_rows or len(keys) != expected_rows
            or not all(math.isfinite(r["score"]) for r in rsa_rows)):
        raise RuntimeError(f"curriculum_nsd_rsa: {len(rsa_rows)} rows, expected {expected_rows}")
    rsa_run = {"launches": probe["launches"], "shapes": probe["shapes"],
               "csv": root / "rsa" / "curriculum_nsd_rsa.csv"}
    check_launches(rsa_run, expected_rdms, "checkpoints · subjects · regions · (layers + 1)")
    rec["curriculum_nsd_rsa"] = {
        "rows": len(rsa_rows), "rdm_launches": probe["launches"],
        "rdm_shapes": [[*k, v] for k, v in sorted(probe["shapes"].items())],
        "mean_score": {name: float(np.mean([r["score"] for r in rsa_rows
                                            if r["model_name"] == name]))
                       for name in checkpoints}}
    rec["seconds"] = seconds
    rec["rsa_peak_mem_gb"] = probe["peak_mem_gb"]
    rec["wall_s"] = time.perf_counter() - t_phase
    emit(rec)
    return rsa_run


def recon_rows(db_path, where: str) -> list:
    """(region, subject_idx, pca_k, layer, score, ci_low, ci_high, bootstrap
    scores) of the reconstruction rows ``where`` selects."""
    with sqlite3.connect(str(db_path)) as conn:
        return [(*r[:7], json.loads(r[7])) for r in conn.execute(
            "SELECT r.region, r.subject_idx, r.pca_k, r.layer, r.score, r.ci_low, r.ci_high, "
            "b.scores FROM results r JOIN bootstrap_distributions b "
            "USING (run_id, compare_method) WHERE r.reconstruct_from_pcs = 1 AND " + where)]


def check_recon_rows(rows, best: dict, ks: list, what: str) -> None:
    """One row per (region, subject, k) with the pair's baseline layer,
    finite scores and CIs, and 1000 finite bootstrap scores."""
    keys = sorted((r[0], str(r[1]), r[2]) for r in rows)
    want = sorted((reg, subj, k) for reg, subj in best for k in ks)
    if keys != want:
        raise RuntimeError(f"{what}: reconstruction rows {keys}, expected {want}")
    for region, subj, k, layer, *vals, boot in rows:
        if layer != best[(region, str(subj))]:
            raise RuntimeError(f"{what}: {region} {subj} k={k} scored {layer}, "
                               f"not the baseline's {best[(region, str(subj))]}")
        if len(boot) != 1000 or not all(math.isfinite(v) for v in (*vals, *boot)):
            raise RuntimeError(f"{what}: {region} {subj} k={k}: non-finite or missing scores")


def recon_f64_check(x, recs: dict) -> dict:
    """The card's reconstructions ``recs`` {k: (n, d) tensor} of the taps
    ``x`` against the same from an f64 economy SVD on the CPU (max |Δ| over
    the largest |value|)."""
    import numpy as np

    t0 = time.perf_counter()
    xd = x.double().cpu().numpy()
    mean = xd.mean(axis=0)
    u, sv, _ = np.linalg.svd(xd - mean, full_matrices=False)
    out = {"shape": list(x.shape), "cpu_svd_s": time.perf_counter() - t0, "tol": PCA_TOL,
           "errors": {}}
    for k, rec in sorted(recs.items()):
        ref = mean + u[:, :k] @ (u[:, :k].T @ (xd - mean))
        err = float(np.abs(rec.double().cpu().numpy() - ref).max() / np.abs(ref).max())
        out["errors"][k] = {"rel_err": err, "gap_k": float(1 - (sv[k] / sv[k - 1]) ** 2)}
        if not err <= PCA_TOL:
            raise RuntimeError(f"reconstruction at k={k} against the f64 SVD: {err} > {PCA_TOL}")
    return out


def phase_reconstruction(meta: dict, tmp: Path, data: dict) -> dict:
    """The PC-reconstruction sweep through run_reconstruction's CLI: a
    1000-way CustomCNN trained here, its NSD baseline eval, then the sweep
    on NSD (e2e's fixture, 2 × 2 pairs, pca_k 1–15, 1000 bootstraps,
    Spearman), TVSD and THINGS (their phases' fixtures, pca_k RECON["k"],
    baseline rows written into a separate results.db). Checks the rows,
    finite scores, 1000 bootstraps a row, one RDM launch per RDM
    (neural + ks × unique layers), and the narrowest NSD layer's
    reconstructions at RECON["check_k"] against an f64 SVD on the CPU.
    Returns the sweep's run (launches, shapes), the checkpoint, the NSD
    layers, fig. 1's RDMs and the two results.dbs."""
    from visreps_tpu_torch import run
    from visreps_tpu_torch.benchmarks import fixture
    from visreps_tpu_torch.core import db
    from visreps_tpu_torch.data import loader
    from visreps_tpu_torch.experiments.reconstruction_analysis import run_reconstruction as rr

    spec = RECON
    rec = {"phase": "reconstruction"}
    t_phase = time.perf_counter()
    seconds = {}
    checkpoint_dir = str(tmp / "recon_checkpoints")
    trainer, seconds["train"] = timed(run.main, [
        "--mode", "train", "--config", str(ROOT / "configs/train/base.json"), "--override",
        "pca_labels=false", f"batchsize={TRAIN['batch']}", f"num_epochs={spec['train_epochs']}",
        "warmup_epochs=0", "num_workers=16", "log_interval=1", "checkpoint_interval=1",
        "log_checkpoints=true", f"checkpoint_dir={checkpoint_dir}",
        *(f"{k}={v}" for k, v in data.items())])
    model_file = f"checkpoint_epoch_{spec['train_epochs']}.pth"
    losses = [h["loss"] for h in trainer.history]
    if not losses or not all(math.isfinite(v) for v in losses) \
            or not (Path(checkpoint_dir) / "cfg1000a" / model_file).is_file():
        raise RuntimeError(f"1000-way training: losses {losses}, no {model_file}?")
    rec["train"] = {"steps": len(losses), "loss": losses}
    t0 = time.perf_counter()
    with environ(**nsd_env(meta)):
        base = run_eval("recon_baseline", meta, [
            "load_model_from=checkpoint", "cfg_id=1000", f"checkpoint_dir={checkpoint_dir}",
            f"checkpoint_model={model_file}"],
            "cfg_id = 1000 AND reconstruct_from_pcs = 0",
            lambda cfg_id, epoch: cfg_id == 1000 and epoch == spec["train_epochs"])
    seconds["baseline_eval"] = time.perf_counter() - t0

    common = ["--checkpoint-dir", checkpoint_dir, "--checkpoint-model", model_file,
              "--cfg-id", "1000", "--seeds", "1", "--n-bootstrap", "1000",
              "--compare-method", "spearman", "--num-workers", "16"]
    subjects = list(range(E2E["n_subjects"]))
    nsd_config = rr.DATASET_CONFIG["nsd"]
    best = rr.query_best_layers("nsd", 1, 1000, checkpoint_dir, "spearman")
    taps, recs, fig1, last = {}, {}, {}, {}
    reconstruct, build = rr.reconstruct_from_pcs, rr.compute_rdm

    def keep_reconstruction(acts, pcas, k):
        out = reconstruct(acts, pcas, k)
        (layer, x), = acts.items()
        last.update(layer=layer, k=k, out=out[layer])
        if k in spec["check_k"]:
            taps[layer] = x
            recs[(layer, k)] = out[layer]
        return out

    def keep_rdm(x, *args, **kwargs):
        rdm = build(x, *args, **kwargs)
        if last and x is last["out"] and last["k"] in spec["fig1_k"].values():
            fig1.setdefault(last["k"], {})[last["layer"]] = rdm.cpu().numpy()
        return rdm

    runs = {}
    rr.DATASET_CONFIG["nsd"] = {**nsd_config, "subjects": subjects}
    rr.reconstruct_from_pcs, rr.compute_rdm = keep_reconstruction, keep_rdm
    try:
        with environ(**nsd_env(meta)), rdm_probe() as probe:
            _, seconds["nsd_sweep"] = timed(rr.main, [
                "--datasets", "nsd", *common, "--pca-k", *map(str, spec["nsd_k"]),
                "--batch-size", "256"])
        runs["nsd"] = probe
    finally:
        rr.DATASET_CONFIG["nsd"] = nsd_config
        rr.reconstruct_from_pcs, rr.compute_rdm = reconstruct, build
    main_db = db.RESULTS_DB_PATH
    check_recon_rows(recon_rows(main_db, "neural_dataset = 'nsd' AND cfg_id = 1000"), best,
                     spec["nsd_k"], "nsd")
    layers = sorted(set(best.values()))
    check_launches(runs["nsd"], len(best) + len(spec["nsd_k"]) * len(layers),
                   "pairs + ks · unique layers")
    narrow = min(taps, key=lambda l: taps[l].shape[1])
    rec["f64_check"] = {"layer": narrow, **recon_f64_check(
        taps[narrow], {k: recs[(narrow, k)] for k in spec["check_k"]})}
    taps.clear(), recs.clear()

    # TVSD and THINGS: their baseline rows in a results.db of their own
    seeded_db = tmp / "recon_baselines.db"
    args = recon_args(checkpoint_dir, model_file)
    tvsd = fixture.ensure_tvsd_fixture(tmp / "fixture", **TVSD)
    things = fixture.ensure_things_fixture(tmp / "recon_fixture", **RECON_THINGS)
    baselines = {("tvsd", r, s): layer for r, layer in spec["tvsd_layers"].items()
                 for s in (0, 1)}
    baselines[("things-behavior", "N/A", "N/A")] = spec["things_layer"]
    cwd, home = os.getcwd(), os.environ.get("BONNER_DATASETS_HOME")
    routes = {}
    db.RESULTS_DB_PATH = seeded_db
    try:
        for (dataset, region, subj), layer in baselines.items():
            cfg = rr.build_cfg(args, 1, dataset).merge(
                {"region": region, "subject_idx": subj, "reconstruct_from_pcs": False})
            db.save_results([{"layer": layer, "compare_method": "spearman", "score": 1.0,
                              "analysis": "rsa"}], cfg)
        for dataset, meta_d, batch in (("tvsd", tvsd, 256), ("things-behavior", things, 512)):
            os.chdir(meta_d["root"])  # both read datasets/neural/... relative to it
            if dataset == "tvsd":
                os.environ["BONNER_DATASETS_HOME"] = meta_d["bonner_home"]
            before = Counter(loader.ROUTES)
            with rdm_probe() as probe:
                _, seconds[f"{dataset}_sweep"] = timed(rr.main, [
                    "--datasets", dataset, *common, "--pca-k", *map(str, spec["k"]),
                    "--batch-size", str(batch), "--uint8-transfer"])
            runs[dataset] = probe
            routes[dataset] = dict(Counter(loader.ROUTES) - before)
            os.chdir(cwd)
    finally:
        os.chdir(cwd)
        db.RESULTS_DB_PATH = main_db
        if home is None:
            os.environ.pop("BONNER_DATASETS_HOME", None)
        else:
            os.environ["BONNER_DATASETS_HOME"] = home
    # THINGS: every id decoded once (the first pass), the exact pass from the cache
    n_things = RECON_THINGS["n_concepts"] * RECON_THINGS["imgs_per_concept"]
    things_routes = routes["things-behavior"]
    if things_routes.get("pil", 0) + things_routes.get("native", 0) != n_things \
            or things_routes.get("cache", 0) != n_things:
        raise RuntimeError(f"THINGS sweep: decode routes {things_routes}, expected "
                           f"{n_things} decoded and {n_things} from the cache")
    for dataset in ("tvsd", "things-behavior"):
        pairs = {(r, str(s)): l for (d, r, s), l in baselines.items() if d == dataset}
        check_recon_rows(recon_rows(seeded_db, f"neural_dataset = '{dataset}'"), pairs,
                         spec["k"], dataset)
        check_launches(runs[dataset], len(pairs) + len(spec["k"]) * len(set(pairs.values())),
                       "pairs + ks · unique layers")

    rec["nsd_layers"] = {f"{r} {s}": l for (r, s), l in best.items()}
    rec["rows"] = {"nsd": len(best) * len(spec["nsd_k"]),
                   "tvsd": 6 * len(spec["k"]), "things-behavior": len(spec["k"])}
    rec["scores"] = {d: [r[:5] for r in recon_rows(
        main_db if d == "nsd" else seeded_db, f"neural_dataset = '{d}'")]
        for d in ("nsd", "tvsd", "things-behavior")}
    rec["rdm_launches"] = {d: r["launches"] for d, r in runs.items()}
    rec["rdm_shapes"] = [[*k, v] for k, v in sorted(
        sum((r["shapes"] for r in runs.values()), Counter()).items())]
    rec["decode_routes"] = routes
    rec["peak_mem_gb"] = max(r["peak_mem_gb"] for r in runs.values())
    rec["seconds"] = seconds
    rec["wall_s"] = time.perf_counter() - t_phase
    emit(rec)
    sweep = {"launches": sum(r["launches"] for r in runs.values()),
             "shapes": sum((r["shapes"] for r in runs.values()), Counter())}
    return {"runs": [base, sweep], "checkpoint_dir": checkpoint_dir, "nsd_layers": best,
            "fig1": fig1, "main_db": main_db, "seeded_db": seeded_db,
            "things_layer": spec["things_layer"]}


def recon_args(checkpoint_dir: str, model_file: str):
    """run_reconstruction's arguments for ``build_cfg``."""
    from types import SimpleNamespace

    return SimpleNamespace(cfg_id=1000, checkpoint_dir=checkpoint_dir, checkpoint_model=model_file,
                           compare_method="spearman", n_bootstrap=1000, batch_size=256,
                           num_workers=16, uint8_transfer=True)


def xor_rdm(codes, weights):
    """Σ_k w_k·xor(b_ik, b_jk) / Σw of (n, bits) 0/1 codes on the CPU: an
    integer sum over bits, then one f32 division."""
    import numpy as np

    w = np.asarray(weights, np.int64)
    total = np.zeros((len(codes), len(codes)), np.int64)
    for j in range(codes.shape[1]):
        total += w[j] * (codes[:, j][:, None] != codes[:, j][None, :])
    return total.astype(np.float32) / np.float32(w.sum())


def phase_binary_pc_rsa(meta: dict, tmp: Path, eigenvectors: Path) -> dict:
    """Binary-PC RSA through its CLI on the card: the coarsegrain phase's
    eigenvectors, seeded AlexNet (``--pretrained none``), e2e's subjects and
    regions, n_pcs 2–20, Spearman and Kendall. Checks 304 finite rows,
    each Hamming RDM of the first subject at BINARY["check_pcs"] bit-equal
    to a CPU XOR sum of the same codes, each neural RDM against the plain
    version of the same rows, and one RDM launch per neural RDM (the
    Hamming RDMs launch none)."""
    import numpy as np
    import torch

    from visreps_tpu_torch.experiments.binary_pc_rsa import main as binary
    from visreps_tpu_torch.ops import rdm_kernel

    spec = BINARY
    rec = {"phase": "binary_pc_rsa"}
    t_phase = time.perf_counter()
    subjects = list(range(E2E["n_subjects"]))
    hamming, neural = [], []
    binary_rdm, build = binary.binary_rdm, binary.compute_rdm

    def keep_hamming(codes, weighted):
        out = binary_rdm(codes, weighted)
        if len(hamming) < 2 * len(binary.REGIONS) * len(spec["check_pcs"]) \
                and codes.shape[1] in spec["check_pcs"]:
            hamming.append((codes.cpu().numpy(), weighted, out.cpu().numpy()))
        return out

    def keep_neural(x, *args, **kwargs):
        out = build(x, *args, **kwargs)
        neural.append((x, out))
        return out

    out_csv = tmp / "binary_pc_rsa" / "binary_pc_rsa.csv"
    binary.binary_rdm, binary.compute_rdm = keep_hamming, keep_neural
    try:
        with environ(**nsd_env(meta)), rdm_probe() as probe:
            rows, seconds = timed(binary.main, [
                "--eigenvectors", str(eigenvectors), "--pretrained", "none",
                "--subjects", *map(str, subjects), "--n-pcs", *map(str, spec["n_pcs"]),
                "--correlations", *spec["correlations"], "--batch-size", "256",
                "--num-workers", "8", "--out", str(out_csv)])
    finally:
        binary.binary_rdm, binary.compute_rdm = binary_rdm, build
    n_rows = len(subjects) * len(spec["n_pcs"]) * len(binary.REGIONS) * 2 * len(spec["correlations"])
    if len(rows) != n_rows or not all(math.isfinite(r["score"]) for r in rows):
        raise RuntimeError(f"binary_pc_rsa: {len(rows)} rows (expected {n_rows}) or non-finite")
    if len(hamming) != 2 * len(binary.REGIONS) * len(spec["check_pcs"]):
        raise RuntimeError(f"binary_pc_rsa: {len(hamming)} Hamming RDMs captured")
    for codes, weighted, got in hamming:
        w = np.arange(codes.shape[1], 0, -1) if weighted else np.ones(codes.shape[1])
        if not np.array_equal(got, xor_rdm(codes, w)):
            raise RuntimeError(f"Hamming RDM ({codes.shape}, weighted {weighted}) differs from "
                               "the CPU XOR sum")
    plain = []
    for x, out in neural:
        xc = x.float() - x.float().mean(dim=1, keepdim=True)
        std = torch.sqrt((xc * xc).mean(dim=1) + 1e-12)
        std = torch.where(std < 1e-11, torch.ones_like(std), std)
        ref = rdm_kernel.rdm_from_centered_reference(xc, std)
        plain.append((out - ref).abs().max().item())
    tol = tolerance(neural[0][0].shape[1], "float32")
    if not max(plain) <= tol:
        raise RuntimeError(f"binary_pc_rsa neural RDMs against the plain version: {plain} > {tol}")
    check_launches(probe, len(subjects) * len(binary.REGIONS), "subjects · regions (neural)")
    rec.update({"rows": len(rows), "seconds": seconds, "hamming_checked": len(hamming),
                "hamming_bit_equal": True, "neural_vs_plain_max": max(plain), "tol": tol,
                "rdm_launches": probe["launches"],
                "rdm_shapes": [[*k, v] for k, v in sorted(probe["shapes"].items())],
                "peak_mem_gb": probe["peak_mem_gb"],
                "mean_score": {f"{c} weighted={w}": float(np.mean(
                    [r["score"] for r in rows if r["correlation"] == c and r["weighted"] == w]))
                    for c in spec["correlations"] for w in (True, False)},
                "wall_s": time.perf_counter() - t_phase})
    emit(rec)
    return {"launches": probe["launches"], "shapes": probe["shapes"], "csv": out_csv}


def export_results(db_paths: list, where: list, out_csv: Path) -> Path:
    """The ``results`` rows of each results.db (its ``where``) as one long
    CSV (blank for NULL), the layout the figure CLIs read."""
    rows, names = [], None
    for path, cond in zip(db_paths, where):
        with sqlite3.connect(str(path)) as conn:
            cur = conn.execute(f"SELECT * FROM results WHERE {cond}")
            names = names or [d[0] for d in cur.description]
            rows += cur.fetchall()
    out_csv.parent.mkdir(parents=True, exist_ok=True)
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(names)
        w.writerows(["" if v is None else v for v in r] for r in rows)
    return out_csv


def db_rows_of(sources: list, columns: str, cond: str, params=()) -> list:
    """``columns`` of the ``results`` rows of each (results.db, where) in
    ``sources`` that also meet ``cond``."""
    rows = []
    for path, where in sources:
        with sqlite3.connect(str(path)) as conn:
            rows += conn.execute(f"SELECT {columns} FROM results WHERE ({where}) AND ({cond})",
                                 params).fetchall()
    return rows


def seed_means(pairs) -> list:
    """[mean score of each seed, seeds sorted] of (seed, score) pairs."""
    by = {}
    for seed, score in pairs:
        by.setdefault(seed, []).append(score)
    return [sum(v) / len(v) for _, v in sorted(by.items())]


def plain_conditions(sources: list, region, pc_layer: str, k1k_layer: str) -> dict:
    """The bar plots' condition scores straight from results.db (figutils
    ``assemble_conditions`` on the exported CSV): per-seed means of the
    untrained (epoch 0) and 1000-class (epoch 20, no PCA labels) rows at
    ``k1k_layer`` and of each PCA granularity's (epoch 20) at ``pc_layer``,
    of one region or of every row."""
    cond, params = ("lower(region) = ?", (region,)) if region else ("1", ())
    rows = db_rows_of(sources, "seed, epoch, lower(layer), pca_labels, pca_n_classes, score",
                      cond, params)
    k1k, pc = k1k_layer.lower(), pc_layer.lower()
    out = {"Untrained": seed_means((r[0], r[5]) for r in rows if r[2] == k1k and r[1] == 0)}
    for n in (2, 4, 8, 16, 32, 64):
        pairs = [(r[0], r[5]) for r in rows
                 if r[2] == pc and r[1] == 20 and r[3] and r[4] == n]
        if pairs:
            out[f"{n} Classes"] = seed_means(pairs)
    out["1000 Classes"] = seed_means((r[0], r[5]) for r in rows
                                     if r[2] == k1k and r[1] == 20 and not r[3])
    return out


def plain_recon_matrix(sources: list, layer: str, max_k: int = 20):
    """Fig. 3's (seeds, max_k) matrix straight from results.db: the mean
    score of each (seed, pca_k) among the reconstruction rows at
    ``layer``, NaN where a k has none."""
    import numpy as np

    rows = db_rows_of(sources, "seed, pca_k, score",
                      "reconstruct_from_pcs = 1 AND lower(layer) = ?", (layer.lower(),))
    seeds = sorted({r[0] for r in rows})
    out = np.full((len(seeds), max_k), np.nan)
    by = {}
    for seed, k, score in rows:
        by.setdefault((seed, k), []).append(score)
    for (seed, k), v in by.items():
        if 1 <= k <= max_k:
            out[seeds.index(seed), k - 1] = sum(v) / len(v)
    return out


def close_series(a, b, rtol: float = 1e-12) -> bool:
    """Equal keys and order, NaN at the same places, values within rtol
    (and 1e-15 absolute, for means that cancel: sums in another order)."""
    import numpy as np

    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(
            close_series(a[k], b[k], rtol) for k in a)
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and np.array_equal(np.isnan(a), np.isnan(b)) and bool(
        np.allclose(a[~np.isnan(a)], b[~np.isnan(b)], rtol=rtol, atol=1e-15))


def same_series(a, b) -> bool:
    """Equal nested series: values bit for bit, NaN where the other has NaN."""
    import numpy as np

    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(same_series(a[k], b[k]) for k in a))
    if hasattr(a, "columns"):  # a figutils Table
        return same_series(a.columns, b.columns)
    if isinstance(a, (list, tuple, np.ndarray)) or isinstance(b, (list, tuple, np.ndarray)):
        a, b = np.asarray(a, dtype=object), np.asarray(b, dtype=object)
        return a.shape == b.shape and all(same_series(x, y) for x, y in zip(a.flat, b.flat))
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return a == b


def phase_figures(tmp: Path, recon: dict, binary_csv: Path, curriculum_csv: Path) -> None:
    """The paper's figure pipeline on this run's results: fig. 1 from four
    RSM npz files of the NSD sweep's card RDMs (k 1 and 2 as the "1K"
    pair, 8 and 15 as the coarse pair) on the card, its Kendall scores
    against the CPU's on the first layer; then a long CSV exported from
    this run's results.db (every row) and the TVSD / THINGS sweep rows,
    read by figs. 2–4 and the bar plots, module 2 on results.db, the
    binary-PC figure on its CSV and plot_curriculum_rsa on curriculum RSA's
    rows (depth and model names added). Each CLI's series must equal the
    same data functions called here on the same input; module 2's NSD
    curve, figs. 2 and 3's matrices and both bar plots' conditions must
    equal a plain recomputation from results.db.
    Prints which figures were not drawn (those drawn need matplotlib)."""
    import numpy as np

    from visreps_tpu_torch.experiments.binary_pc_rsa import visualize
    from visreps_tpu_torch.experiments.coarse_grain_benefits import (
        curriculum_nsd_rsa, plot_curriculum_rsa)
    from visreps_tpu_torch.experiments.neurips_2025 import figutils
    from visreps_tpu_torch.experiments.neurips_2025.fig1 import model_reps_rsa_comparisons as fig1
    from visreps_tpu_torch.experiments.neurips_2025.fig2 import bar_plot_nsd, reconstructed_rsa_nsd
    from visreps_tpu_torch.experiments.neurips_2025.fig3 import (
        bar_plot_things, full_vs_pcs_things, reconstructed_rsa_things)
    from visreps_tpu_torch.experiments.neurips_2025.fig4 import full_vs_pcs_nsd
    from visreps_tpu_torch.experiments.reconstruction_analysis import plot as recon_plot

    out = tmp / "figures"
    rec = {"phase": "figures", "matplotlib": figutils.matplotlib_available()}
    t_phase = time.perf_counter()
    checks = {}

    # fig. 1 on the card, and its first layer on the CPU
    base = out / "RSMs" / "pca4cls"
    base.mkdir(parents=True)
    names = {"f1": "rsms_nsd_pca_labels_False_pca_k_2_cfgid_1_seed_1.npz",
             "f2": "rsms_nsd_pca_labels_False_pca_k_2_cfgid_1_seed_2.npz",
             "t1": "rsms_nsd_pca_labels_True_cfgid_2_seed_1.npz",
             "t2": "rsms_nsd_pca_labels_True_cfgid_2_seed_2.npz"}
    rsms = {key: recon["fig1"][k] for key, k in RECON["fig1_k"].items()}
    for key, name in names.items():
        np.savez(base / name, **rsms[key])
    t0 = time.perf_counter()
    series = fig1.main(["--base_rsm_dir", str(out / "RSMs"), "--output_dir", str(out / "fig1")])
    rec["fig1_s"] = time.perf_counter() - t0
    first = series["layers"][0]
    t0 = time.perf_counter()
    cpu = fig1.compare_layers(*({first: rsms[k][first]} for k in ("f1", "f2", "t1", "t2")),
                              "Kendall", device="cpu")
    rec["fig1_cpu_s"] = time.perf_counter() - t0
    diff = max(abs(series[k][0] - cpu[i + 1][0]) for i, k in enumerate(("f1f2", "t1t2", "f1t1")))
    rec["fig1"] = {**series, "cpu_max_abs_diff": diff, "tol": FIG1_TOL}
    if not diff <= FIG1_TOL:
        raise RuntimeError(f"fig1 Kendall scores: card against CPU {diff} > {FIG1_TOL}")

    # the long CSV and the figure CLIs
    sources = [(recon["main_db"], "1"), (recon["seeded_db"], "reconstruct_from_pcs = 1")]
    long_csv = export_results(*map(list, zip(*sources)), out / "results_long.csv")
    table = figutils.read_csv(long_csv)
    rec["long_csv_rows"] = len(table)
    best = recon["nsd_layers"]
    ventral = best[("ventral visual stream", "0")]
    early = best[("early visual stream", "0")]
    things = recon["things_layer"]
    runs = {
        "fig2_recon": (reconstructed_rsa_nsd.main, [
            "--recon_csv", str(long_csv), "--baseline_csv", str(long_csv), "--layer", ventral,
            "--out", str(out / "fig2" / "recon.png")],
            lambda: {"recon": reconstructed_rsa_nsd.recon_matrix(
                table, "ventral visual stream", ventral, "Spearman"),
                "untrained": reconstructed_rsa_nsd.baseline_band(
                    table, "ventral visual stream", ventral, "Spearman", epoch=0),
                "best_pc": reconstructed_rsa_nsd.baseline_band(
                    table, "ventral visual stream", ventral, "Spearman", epoch=20,
                    pca_n_classes=64)}),
        "fig2_bar": (bar_plot_nsd.main, [
            "--csv", str(long_csv), "--pc_layer", early, "--k1k_layer", early,
            "--out", str(out / "fig2" / "bar.png")],
            lambda: figutils.assemble_conditions(table.take(figutils.eq(
                figutils.str_lower(table["region"]), "early visual stream")), early, early)),
        "fig3_recon": (reconstructed_rsa_things.main, [
            "--recon_csv", str(long_csv), "--baseline_csv", str(long_csv), "--layer", things,
            "--out", str(out / "fig3" / "recon.png")],
            lambda: {"recon": reconstructed_rsa_things.recon_matrix(table, things, "Spearman"),
                     "untrained": reconstructed_rsa_things.baseline_band(
                         table, things, "Spearman", epoch=0),
                     "best_pc": reconstructed_rsa_things.baseline_band(
                         table, things, "Spearman", epoch=20, pca_n_classes=64)}),
        "fig3_full": (full_vs_pcs_things.main, [
            "--csv", str(long_csv), "--out", str(out / "fig3" / "full.png")],
            lambda: dict(zip(("initial", "final", "pca"), full_vs_pcs_things.prepare_series(
                table, "Spearman", full_vs_pcs_things.LAYER_ORDER)))),
        "fig3_bar": (bar_plot_things.main, [
            "--csv", str(long_csv), "--pc_layer", things, "--k1k_layer", things,
            "--out", str(out / "fig3" / "bar.png")],
            lambda: figutils.assemble_conditions(table, things, things)),
        "fig4": (full_vs_pcs_nsd.main, [
            "--csv", str(long_csv), "--out", str(out / "fig4" / "full.png")],
            lambda: dict(zip(("initial", "final", "pca"), full_vs_pcs_things.prepare_series(
                table.take(figutils.eq(figutils.str_lower(table["region"]),
                                       "ventral visual stream")),
                "Spearman", full_vs_pcs_things.LAYER_ORDER)))),
        "reconstruction_plot": (recon_plot.main, [
            "--db", str(recon["main_db"]), "--out_dir", str(out / "recon")],
            lambda: {name: recon_plot.dataset_series(recon["main_db"], name, regions)
                     for name, regions, _ in recon_plot.DATASETS}),
    }
    depth = curriculum_nsd_rsa.normalized_depth(curriculum_nsd_rsa.LAYERS)
    model_names = {"untrained": None, "64way": plot_curriculum_rsa.MODEL_NAMES[1],
                   "64to1000": plot_curriculum_rsa.MODEL_NAMES[2]}
    with open(curriculum_csv) as f:
        cur_rows = [{"model_name": model_names[r["model_name"]], "region": r["region"],
                     "depth_normalized": depth[r["layer"]], "rsa_score": r["score"]}
                    for r in csv.DictReader(f) if model_names.get(r["model_name"])]
    cur_csv = out / "curriculum_rsa_depth.csv"
    with open(cur_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(cur_rows[0]))
        w.writeheader()
        w.writerows(cur_rows)
    runs["curriculum"] = (plot_curriculum_rsa.main, [
        "--input", str(cur_csv), "--out", str(out / "curriculum.png")],
        lambda: plot_curriculum_rsa.curves(cur_rows))
    runs["binary_visualize"] = (visualize.main, [
        "--results", str(binary_csv), "--cnn_baseline", str(out / "no_cnn_baseline.csv"),
        "--out_dir", str(out / "binary")],
        lambda: {r: visualize.region_series(r, visualize.average_over_subjects(
            visualize._read_csv(binary_csv)), {}) for r in visualize.REGIONS})
    outputs = {}
    for name, (cli, argv, again) in runs.items():
        outputs[name] = got = cli(argv)
        checks[name] = same_series(figutils._jsonable(got), figutils._jsonable(again()))
    rec["series_equal"] = checks
    if not all(checks.values()):
        raise RuntimeError(f"figure series differ from the data functions: {checks}")

    # the bar plots' conditions and fig. 3's matrix against results.db directly
    direct = {
        "fig2_bar": (outputs["fig2_bar"],
                     plain_conditions(sources, "early visual stream", early, early)),
        "fig3_bar": (outputs["fig3_bar"], plain_conditions(sources, None, things, things)),
        "fig3_recon": (reconstructed_rsa_things.recon_matrix(table, things, "Spearman"),
                       plain_recon_matrix(sources, things)),
    }
    rec["vs_results_db"] = {name: close_series(got, want) for name, (got, want) in direct.items()}
    if not all(rec["vs_results_db"].values()):
        raise RuntimeError(f"figure series differ from results.db: "
                           f"{ {n: direct[n] for n, ok in rec['vs_results_db'].items() if not ok} }")

    # module 2's NSD curve and fig. 2's matrix against results.db directly
    with sqlite3.connect(str(recon["main_db"])) as conn:
        direct = conn.execute(
            "SELECT region, pca_k, subject_idx, score FROM results WHERE reconstruct_from_pcs = 1 "
            "AND cfg_id = 1000 AND neural_dataset = 'nsd' AND compare_method = 'spearman' "
            "ORDER BY region, pca_k, subject_idx").fetchall()
    curves = recon_plot.dataset_series(recon["main_db"], "nsd", recon_plot.DATASETS[0][1])
    for region in ("early visual stream", "ventral visual stream"):
        by_k = {}
        for reg, k, _, score in direct:
            if reg == region:
                by_k.setdefault(k, []).append(score)
        want = [sum(v) / len(v) for _, v in sorted(by_k.items())]
        got = curves[region]["curve"]["mean"].tolist()
        if got != want or curves[region]["curve"]["pca_k"].tolist() != sorted(by_k):
            raise RuntimeError(f"module 2's {region} curve {got} is not results.db's {want}")
    fig2 = reconstructed_rsa_nsd.recon_matrix(table, "ventral visual stream", ventral, "Spearman")
    want = np.full(20, np.nan)
    ventral_k = {}
    for reg, k, subj, score in direct:
        if reg == "ventral visual stream" and best[(reg, str(subj))] == ventral:
            ventral_k.setdefault(k, []).append(score)
    for k, v in ventral_k.items():
        want[k - 1] = sum(v) / len(v)
    rec["fig2_vs_db_max_abs"] = float(np.nanmax(np.abs(fig2[0] - want)))
    if fig2.shape != (1, 20) or not np.array_equal(np.isnan(fig2[0]), np.isnan(want)) \
            or not rec["fig2_vs_db_max_abs"] <= 1e-12:  # the CSV's 17 digits, parsed as pandas does
        raise RuntimeError(f"fig2's matrix {fig2} is not results.db's {want}")
    rec["not_drawn"] = [] if rec["matplotlib"] else sorted(
        str(p.with_suffix(".png").relative_to(out)) for p in out.rglob("*.json"))
    rec["wall_s"] = time.perf_counter() - t_phase
    emit(rec)


def flat_jpegs(tmp: Path, data: dict):
    """The train phase's JPEGs as one folder of links (the stimulus-folder
    CLIs read one folder), with each image's class index (its synset's, in
    the fixture's label file) and synset, in the folder's sorted order."""
    import numpy as np

    flat = tmp / "repr_jpegs"
    flat.mkdir()
    for p in Path(data["dataset_path"]).rglob("*.JPEG"):
        (flat / p.name).symlink_to(p)
    names = sorted(f.name for f in flat.iterdir())
    classes = json.loads(Path(data["label_file"]).read_text())
    synsets = np.array([n.split("_")[0] for n in names])
    return flat, np.array([classes[s] for s in synsets]), synsets


def _scalar_err(got: float, want: float) -> float:
    """|got − want| / |want| (0 when both are NaN)."""
    if math.isnan(want) and math.isnan(got):
        return 0.0
    return abs(got - want) / max(abs(want), 1e-30)


def dim_errors(card: dict, cpu: dict) -> dict:
    """Largest card-vs-CPU error of each dimensionality metric over the
    layers (eigenvalues over the largest one, the others relative), the
    layer where it is largest, and the layers whose 90 % counts differ."""
    errs = {}

    def note(metric, layer, err):
        if err > errs.get(metric, (-1.0, None))[0]:
            errs[metric] = (err, layer)

    n90 = []
    for layer in cpu["pr"]:
        note("eigenvalues", layer, _rel_err(card["eigenvalues"][layer], cpu["eigenvalues"][layer]))
        note("participation_ratio", layer, _scalar_err(card["pr"][layer], cpu["pr"][layer]))
        for k in ("dimension", "std"):
            note(f"twonn_{k}", layer, _scalar_err(card["twonn"][layer][k],
                                                   cpu["twonn"][layer][k]))
        for k in ("mean", "std"):
            note(f"hoyer_{k}", layer, _scalar_err(card["sparsity"][layer][k],
                                                  cpu["sparsity"][layer][k]))
        note("fraction_active", layer, _scalar_err(card["sparsity"][layer]["frac_active"],
                                                   cpu["sparsity"][layer]["frac_active"]))
        if card["n90"][layer] != cpu["n90"][layer]:
            n90.append(layer)
    return {"errors": errs, "n90_differ": n90}


def dim_tol(metric: str) -> float:
    return TWONN_TOL if metric.startswith("twonn") else REPR_TOL


def csv_vs_cpu(path: Path, cpu: dict) -> dict:
    """Largest gap of each dimensionality CSV column from the CPU's metric,
    beyond the CSV's rounding, relative to the CPU value."""
    fields = {"participation_ratio": (lambda c, l: c["pr"][l], 3),
              "twonn_id": (lambda c, l: c["twonn"][l]["dimension"], 3),
              "twonn_se": (lambda c, l: c["twonn"][l]["std"], 3),
              "hoyer_sparsity_mean": (lambda c, l: c["sparsity"][l]["mean"], 4),
              "hoyer_sparsity_std": (lambda c, l: c["sparsity"][l]["std"], 4),
              "fraction_active": (lambda c, l: c["sparsity"][l]["frac_active"], 4)}
    worst = dict.fromkeys(fields, 0.0)
    with open(path) as f:
        for row in csv.DictReader(f):
            if row["layer"] not in cpu["pr"]:  # a tap the CPU did not recompute
                continue
            for key, (get, digits) in fields.items():
                want = get(cpu, row["layer"])
                gap = max(abs(float(row[key]) - want) - 0.5 * 10.0**-digits, 0.0)
                worst[key] = max(worst[key], gap / max(abs(want), 1e-30))
    return worst


def phase_representation(tmp: Path, data: dict, checkpoint_dir: str, meta: dict) -> dict:
    """experiments/representation_analysis on the card through its CLIs.
    dimensionality compares two trained CustomCNN checkpoints (the train
    phase's 32-way and the runners' 4-way, epoch 1) on the 1,600 JPEGs, all
    taps pre and post at SRP k = 4096, Two-NN on every row: every metric
    and the CSV against a CPU recomputation from the same taps. Its taps
    are written as the npz and npy files variance_ratio, nearest_neighbors,
    two_pcs_compare and run_all read, each held to the CPU (accuracies
    exactly, neighbours up to swaps of near-tied cosines; fc2's PCs up to
    sign; run_all's rows to the CPU metrics). task_brain_alignment on the
    32-way checkpoint's fc2 of e2e's first subject against the CPU's
    Fisher weights and alignment of the card's brain ridge.
    rsm_comparison of the untrained
    AlexNet and ResNet18: one RDM launch per tap, a symmetric similarity
    matrix with a unit diagonal. Returns the RDM launches and shapes."""
    import numpy as np
    import torch

    from visreps_tpu_torch.core.config import Config
    from visreps_tpu_torch.data.neural import get_neural_loader
    from visreps_tpu_torch.experiments.representation_analysis import (
        dim_metrics, dimensionality, nearest_neighbors, rsm_comparison, run_all,
        task_brain_alignment, two_pcs_compare, variance_ratio)
    from visreps_tpu_torch.models.extractor import FeatureExtractor
    from visreps_tpu_torch.models.zoo import load_model

    spec = REPR
    t_phase = time.perf_counter()
    flat, labels, synsets = flat_jpegs(tmp, data)
    ckpts, out = tmp / "repr_checkpoints", tmp / "representation"
    ckpts.mkdir()
    out.mkdir()
    a, b = spec["cfg_ids"]
    (ckpts / f"cfg{a}a").symlink_to(Path(checkpoint_dir) / f"cfg{a}a")
    (ckpts / f"cfg{b}a").symlink_to(tmp / "runner_checkpoints" / f"cfg{b}a")
    seconds, checks = {}, {}

    stores, extract = [], dimensionality._extract

    def keep(args, cfg_id):
        stores.append(extract(args, cfg_id))
        return stores[-1]

    dimensionality._extract = keep
    try:
        per_model, seconds["dimensionality_s"] = timed(dimensionality.main, [
            "--checkpoint-dir", str(ckpts), "--cfg-id", str(a), "--compare-cfg-id", str(b),
            "--checkpoint-model", spec["checkpoint"], "--stimuli-dir", str(flat),
            "--batch-size", str(spec["batch"]), "--out", str(out / "dimensionality.csv"),
            "--fig-dir", str(out / "dimensionality_figs"), "--device", "cuda"])
    finally:
        dimensionality._extract = extract
    names = list(per_model)
    hosts = [{k: v.cpu().numpy() for k, v in acts.items()} for acts in stores]
    del stores
    n_rows = {v.shape for h in hosts for v in h.values()}
    if n_rows != {(TRAIN["n_images"], spec["srp_k"])} or len(hosts[0]) != 14:
        raise RuntimeError(f"dimensionality: taps {len(hosts[0])} of shapes {n_rows}")
    t0 = time.perf_counter()
    cpu = {name: dim_metrics.compute_all_metrics({t: h[t] for t in spec["cpu_taps"]},
                                                 spec["cpu_taps"], device="cpu")
           for name, h in zip(names, hosts)}
    seconds["dimensionality_cpu_s"] = time.perf_counter() - t0
    checks["dimensionality"] = {name: dim_errors(per_model[name], cpu[name]) for name in names}
    checks["dimensionality_csv"] = csv_vs_cpu(out / "dimensionality.csv", cpu[names[0]])

    layer = spec["layer"]
    npz, npy = [], []
    for name, h in zip(names, hosts):
        np.savez(out / f"{name}.npz", labels=labels, **h)
        np.save(out / f"{name}_{layer}.npy", h[layer])
        np.savez(out / f"{name}_pcs.npz", **{n: h[f"{n}_post"] for n in two_pcs_compare.LAYERS})
        npz.append(str(out / f"{name}.npz"))
        npy.append(str(out / f"{name}_{layer}.npy"))
    np.save(out / "labels.npy", labels)

    stats, seconds["variance_ratio_s"] = timed(variance_ratio.main, [
        "--features", *npy, "--labels", str(out / "labels.npy"), "--names", *names,
        "--out", str(out / "variance_ratio.png")])
    want = [variance_ratio.variance_ratio_stats(h[layer], labels)["ratio"] for h in hosts]
    checks["variance_ratio_equal"] = [s["ratio"] for s in stats] == want

    nn_acc, seconds["nearest_neighbors_s"] = timed(nearest_neighbors.main, [
        "--features", *npy, "--labels", str(out / "labels.npy"), "--names", *names,
        "--n-queries", str(spec["n_queries"]), "--k", str(spec["k"]),
        "--out", str(out / "nearest_neighbors.png"), "--device", "cuda"])
    card_topk = json.loads((out / "nearest_neighbors.json").read_text())["top_k"]
    queries = nearest_neighbors.pick_queries(labels, None, spec["n_queries"],
                                             np.random.RandomState(nearest_neighbors.SEED))
    nn = {"swapped": 0, "tie_gap": 0.0, "accuracy_equal": True}
    for name, h in zip(names, hosts):
        top_k, acc = nearest_neighbors.retrieve(h[layer], labels, queries, spec["k"],
                                                device="cpu")
        sims = nearest_neighbors._cosine_topk_scores(
            torch.from_numpy(h[layer]), torch.from_numpy(queries)).numpy()
        card = np.asarray(card_topk[name])
        rows = np.arange(len(queries))[:, None]
        nn["swapped"] += int((card != top_k).sum())
        gap = float(np.abs(sims[rows, card] - sims[rows, top_k]).max())
        nn["tie_gap"] = max(nn["tie_gap"], gap)
        # the card's accuracy from its own neighbours (tied swaps can move it)
        own = np.mean(labels[card] == labels[queries][:, None], axis=1)
        nn["accuracy_equal"] &= float(own.mean()) == nn_acc[name]
        nn["accuracy_gap"] = max(nn.get("accuracy_gap", 0.0), abs(float(acc.mean()) - nn_acc[name]))
    checks["nearest_neighbors"] = nn

    pcs, seconds["two_pcs_compare_s"] = timed(two_pcs_compare.main, [
        "--features_pre", str(out / f"{names[0]}_pcs.npz"),
        "--features_trained", str(out / f"{names[1]}_pcs.npz"), "--n_classes", str(b),
        "--out_dir", str(out), "--device", "cuda"])
    pcs_err, var_err = 0.0, 0.0
    for h, key in zip(hosts, ("pretrained", "trained")):
        p_cpu, v_cpu = two_pcs_compare.compute_pca(h["fc2_post"], device="cpu")
        p_card, v_card = pcs[f"fc2_{key}_pcs"], pcs[f"fc2_{key}_var"]
        order = np.argsort(-v_card, kind="stable")  # undo align_pcs' swap
        p_card, v_card = p_card[:, order], v_card[order]
        pcs_err = max(pcs_err, _rel_err(p_card * np.sign((p_card * p_cpu).sum(axis=0)), p_cpu))
        var_err = max(var_err, _rel_err(v_card, v_cpu))
    checks["two_pcs"] = {"pcs_up_to_sign": pcs_err, "variance": var_err}

    summary, seconds["run_all_s"] = timed(run_all.main, [
        "--features", *npz, "--names", *names, "--layer", layer,
        "--out_dir", str(out / "run_all"), "--device", "cuda"])
    checks["run_all_rows"] = {key: max(_scalar_err(row[key], get(cpu[row["model"]], row["layer"]))
                                       for row in summary["dimensionality"]
                                       if row["layer"] in spec["cpu_taps"])
                              for key, get in (
                                  ("participation_ratio", lambda c, l: c["pr"][l]),
                                  ("twonn_id", lambda c, l: c["twonn"][l]["dimension"]),
                                  ("hoyer_sparsity", lambda c, l: c["sparsity"][l]["mean"]))}
    cpu_nn = run_all.run_nearest_neighbors([h[layer] for h in hosts], labels, names, str(out),
                                           device="cpu")
    checks["run_all_steps_equal"] = (summary["nearest_neighbors"] == cpu_nn and [
        s["ratio"] for s in summary["variance_ratio"]] == want)

    with environ(**nsd_env(meta)):
        model = load_model(Config({"load_model_from": "checkpoint", "seed": 1, "cfg_id": a,
                                   "checkpoint_dir": str(ckpts),
                                   "checkpoint_model": spec["checkpoint"]}), device="cuda")
        targets, loader = get_neural_loader(Config({
            "neural_dataset": "nsd", "region": spec["region"], "subject_idx": 0,
            "batchsize": spec["batch"], "num_workers": 16}))
        acts, ids = FeatureExtractor(model, ["fc2"], srp_k=4096, device="cuda").get_activations(
            loader, store="host")
    responses = {**targets["train"], **targets["test"]}
    brain = acts[layer].numpy()
    neural = np.stack([np.asarray(responses[str(i)], np.float32) for i in ids])
    for name, arr in (("task_features", hosts[0][layer]), ("task_labels", labels),
                      ("brain_features", brain), ("brain_responses", neural)):
        np.save(out / f"{name}.npy", arr)
    row, seconds["task_brain_alignment_s"] = timed(task_brain_alignment.main, [
        "--task-features", str(out / "task_features.npy"),
        "--task-labels", str(out / "task_labels.npy"),
        "--brain-features", str(out / "brain_features.npy"),
        "--brain-responses", str(out / "brain_responses.npy"),
        "--layer", "fc2", "--out-dir", str(out / "task_brain"), "--device", "cuda"])
    # The brain ridge runs on the card here (the CPU's took 16-30 s; cut in
    # PR 16: ridge card = CPU stays held by encoding_check); the Fisher
    # weights and the alignment are recomputed on the CPU from its weights.
    brain_w, mean_r, alpha_med = task_brain_alignment.brain_predictive_weights(
        brain, neural, device="cuda")
    t0 = time.perf_counter()
    task_w = task_brain_alignment.fisher_discriminant_per_dim(
        hosts[0][layer], labels, int(labels.max()) + 1, device="cpu").numpy()
    cpu_row = {"encoding_mean_r": mean_r, "alpha_median": alpha_med,
               **task_brain_alignment.compute_alignment(task_w, brain_w, device="cpu")}
    seconds["task_brain_alignment_cpu_s"] = time.perf_counter() - t0
    checks["task_brain_alignment"] = {k: abs(row[k] - v) for k, v in cpu_row.items()}

    with rdm_probe() as probe:
        (rdms, sim), seconds["rsm_comparison_s"] = timed(rsm_comparison.main, [
            "--stimuli-dir", str(flat), "--models", *spec["models"],
            "--batch-size", str(spec["batch"]), "--out", str(out / "rsm_comparison.npz"),
            "--device", "cuda"])
    saved = np.load(out / "rsm_comparison.npz")
    checks["rsm"] = {"asymmetry": float(np.abs(sim - sim.T).max()),
                     "diag_err": float(np.abs(np.diag(sim) - 1.0).max()),
                     "finite": bool(np.isfinite(sim).all()),
                     "names_saved": saved["names"].tolist() == list(rdms)}

    rec = {"phase": "representation", "seconds": time.perf_counter() - t_phase, **seconds,
           "n_images": TRAIN["n_images"], "models": names, "taps": len(hosts[0]),
           "participation_ratio": {n: per_model[n]["pr"] for n in names},
           "twonn_id": {n: {k: v["dimension"] for k, v in per_model[n]["twonn"].items()}
                        for n in names},
           "variance_ratio": [s["ratio"] for s in stats], "retrieval": nn_acc,
           "pc_variance": {n: pcs[f"fc2_{k}_var"].tolist()
                           for n, k in zip(names, ("pretrained", "trained"))},
           "task_brain": row, "brain_shape": list(neural.shape),
           "rsm_taps": len(rdms), "rdm_launches": probe["launches"],
           "rdm_shapes": [[*k, v] for k, v in sorted(probe["shapes"].items())],
           "peak_mem_gb": probe["peak_mem_gb"], "checks": checks, "tol": REPR_TOL,
           "twonn_tol": TWONN_TOL, "nn_tie_tol": NN_TIE_TOL, "tba_tol": TBA_TOL,
           "rsm_tol": RSM_TOL}
    emit(rec)
    failures = [f"dimensionality {n}: {c}" for n, c in checks["dimensionality"].items()
                if c["n90_differ"] or any(not err <= dim_tol(m)
                                          for m, (err, _) in c["errors"].items())]
    failures += [k for k in ("variance_ratio_equal", "run_all_steps_equal") if not checks[k]]
    nn = checks["nearest_neighbors"]
    if not (nn["accuracy_equal"] and nn["tie_gap"] <= NN_TIE_TOL):
        failures.append("nearest_neighbors")
    for key in ("dimensionality_csv", "run_all_rows"):
        if any(not err <= dim_tol(m) for m, err in checks[key].items()):
            failures.append(key)
    if not max(checks["two_pcs"].values()) <= REPR_TOL:
        failures.append("two_pcs")
    # alpha_median is reported, not held: on the fixture's noise responses the
    # CV curves are flat at large alphas and roundoff picks each voxel's alpha
    # a top-K overlap moves in steps of 1/K: its gap is held in elements (K ·
    # TBA_TOL of them, rounded down), not as a float, whose rounding read one
    # element of 1,000 as 1.0000000000000009e-3 > 1e-3
    tba = {k: v for k, v in checks["task_brain_alignment"].items() if k != "alpha_median"}
    overlaps = {k: (round(v * int(k.split("_")[1])), int(k.split("_")[1]) * TBA_TOL)
                for k, v in tba.items() if k.startswith("top_")}
    if not (tba["encoding_mean_r"] <= REPR_TOL
            and max(v for k, v in tba.items() if k not in overlaps) <= TBA_TOL
            and all(n <= math.floor(allowed + 1e-9) for n, allowed in overlaps.values())):
        failures.append("task_brain_alignment")
    rsm = checks["rsm"]
    if not (rsm["asymmetry"] <= RSM_TOL and rsm["diag_err"] <= RSM_TOL and rsm["finite"]
            and rsm["names_saved"]):
        failures.append("rsm_comparison")
    if failures:
        raise RuntimeError(f"representation: {failures}: {checks}")
    check_launches(probe, len(rdms), "one per tap RDM")
    return {"launches": probe["launches"], "shapes": probe["shapes"], "hosts": hosts,
            "names": names, "labels": labels, "synsets": synsets, "npz": npz, "out": out}


def phase_semantic(tmp: Path, meta: dict, rep: dict) -> dict:
    """experiments/semantic_analysis on the card. semantic_alignment's eval
    of the untrained AlexNet on e2e's first subject and region against a
    seeded stand-in caption-embedding npz over the fixture's ids, with and
    without reconstruct_from_pcs, into a fresh results.db: one RDM launch
    per tap and one for the embeddings per eval, a row per tap, and the
    scores against the CPU's on the same taps. Then, on the representation
    phase's fc2 taps, pc_semantic_analysis through ``--ancestors-csv`` (the
    fixture's synsets as categories, the PCs of the first model's fc2 from
    a card eigh), fine_grained_structure and plot_semantic_classes_umap,
    which write their data and embed or draw only where matplotlib and an
    embedding backend import. Returns the RDM launches and shapes."""
    import numpy as np
    import torch

    from visreps_tpu_torch.core import db
    from visreps_tpu_torch.core.config import Config
    from visreps_tpu_torch.experiments.neurips_2025.figutils import matplotlib_available
    from visreps_tpu_torch.experiments.representation_analysis.utils import embedding_backend
    from visreps_tpu_torch.experiments.semantic_analysis import (
        fine_grained_structure, pc_semantic_analysis, plot_semantic_classes_umap,
        semantic_alignment)
    from visreps_tpu_torch.models import extractor as extractor_mod
    from visreps_tpu_torch.ops.rdm import compute_rdm, compute_rdm_correlation
    from visreps_tpu_torch.ops.pca import reconstruct_from_pcs

    spec = SEMANTIC
    t_phase = time.perf_counter()
    out = tmp / "semantic"
    out.mkdir()
    n_stimuli = E2E["n_shared"] + E2E["n_subjects"] * E2E["n_unique"]
    emb = np.random.default_rng(0).standard_normal((n_stimuli, spec["d_emb"]), np.float32)
    np.savez(out / "gemini_representations.npz", stimulus_ids=np.arange(n_stimuli),
             gemini_representations=emb)
    cfg = {"mode": "eval", "neural_dataset": "nsd", "region": REPR["region"], "subject_idx": 0,
           "load_model_from": "torchvision", "model_name": "AlexNet",
           "pretrained_dataset": "none", "seed": 1, "return_nodes": spec["nodes"],
           "extract_pre_and_post": True, "srp_k": 4096, "batchsize": REPR["batch"],
           "num_workers": 16, "compare_method": "spearman", "analysis": "rsa",
           "gemini_features_path": str(out / "gemini_representations.npz"),
           "log_expdata": True, "pca_k": spec["pca_k"]}
    stores, get = [], extractor_mod.FeatureExtractor.get_activations

    def keep(self, *args, **kwargs):
        stores.append(get(self, *args, **kwargs))
        return stores[-1]

    db_path, saved_db = out / "results.db", db.RESULTS_DB_PATH
    runs, seconds, launches, shapes = {}, {}, [], Counter()
    extractor_mod.FeatureExtractor.get_activations = keep
    db.RESULTS_DB_PATH = db_path
    try:
        with environ(**nsd_env(meta)):
            for recon in (False, True):
                with rdm_probe() as probe:
                    runs[recon], seconds[f"eval_recon_{recon}_s"] = timed(
                        semantic_alignment.eval, Config({**cfg, "reconstruct_from_pcs": recon}),
                        device="cuda")
                launches.append(probe["launches"])
                shapes += probe["shapes"]
    finally:
        extractor_mod.FeatureExtractor.get_activations = get
        db.RESULTS_DB_PATH = saved_db
    with sqlite3.connect(str(db_path)) as conn:
        db_rows = conn.execute("SELECT reconstruct_from_pcs, layer, score FROM results "
                               "WHERE analysis = 'semantic_alignment'").fetchall()

    t0 = time.perf_counter()
    acts, ids = stores[0]
    embeddings = semantic_alignment.load_embeddings(cfg["gemini_features_path"])
    emb_rdm = compute_rdm(torch.from_numpy(np.stack([embeddings[str(i)] for i in ids])))
    score_err = {False: 0.0, True: 0.0}
    for recon, rows in runs.items():
        for row in (rows[:spec["recon_check"]] if recon else rows[::spec["tap_stride"]]):
            a = acts[row["layer"]]
            if recon:
                a = reconstruct_from_pcs({"a": a}, spec["pca_k"], device="cpu")["a"]
            want = compute_rdm_correlation(compute_rdm(a), emb_rdm, "spearman")
            score_err[recon] = max(score_err[recon], abs(row["score"] - want))
    seconds["cpu_check_s"] = time.perf_counter() - t0
    n_taps = 2 * len(spec["nodes"])
    db_ok = len(db_rows) == 2 * n_taps and sorted(db_rows) == sorted(
        (int(recon), r["layer"], r["score"]) for recon, rows in runs.items() for r in rows)

    names, hosts, labels, synsets = rep["names"], rep["hosts"], rep["labels"], rep["synsets"]
    layer = REPR["layer"]
    fc2 = hosts[0][layer]
    t0 = time.perf_counter()
    x = torch.from_numpy(fc2).cuda()
    mean = x.mean(dim=0)
    lam, vec = torch.linalg.eigh((x - mean).T @ (x - mean) / (len(fc2) - 1))
    order = torch.argsort(lam, descending=True, stable=True)
    np.savez(out / "eigenvectors.npz", eigenvectors=vec[:, order].cpu().numpy(),
             mean=mean.cpu().numpy())
    image_names = np.array([f"{s}_{i}.JPEG" for i, s in enumerate(synsets)])
    np.savez(out / "features_fc2.npz", features=fc2, image_names=image_names)
    with open(out / "ancestors.csv", "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["image", "category"])
        writer.writerows([n, f"{s}.n.01"] for n, s in zip(image_names, synsets))
    pc = pc_semantic_analysis.main([
        "--features", str(out / "features_fc2.npz"), "--eigenvectors",
        str(out / "eigenvectors.npz"), "--pc", "1", "--ancestors-csv",
        str(out / "ancestors.csv"), "--out-dir", str(out / "pc_histogram")])
    seconds["pc_semantic_s"] = time.perf_counter() - t0

    sem = (labels % spec["n_sem"]).astype(np.int64)  # class k → semantic group k mod 8
    np.save(out / "sem_labels.npy", sem)
    np.save(out / "synsets.npy", synsets)
    t0 = time.perf_counter()
    n_animals = fine_grained_structure.main([
        "--features", *rep["npz"], "--layer", layer, "--sem_labels", str(out / "sem_labels.npy"),
        "--synsets", str(out / "synsets.npy"), "--names", *names,
        "--out", str(out / "fine_grained_animals.png")])
    grid = plot_semantic_classes_umap.main([
        "--features", *rep["npz"], "--layer", layer, "--labels", str(out / "sem_labels.npy"),
        "--names", *names, "--out", str(out / "semantic_classes_umap.png")])
    seconds["embedding_data_s"] = time.perf_counter() - t0
    written = {p: (out / p).is_file() for p in ("fine_grained_animals.npz",
                                                 "semantic_classes_umap.npz",
                                                 "pc_histogram/pc1_histogram.json")}
    drawn = {p: (out / p).is_file() for p in ("fine_grained_animals.png",
                                               "semantic_classes_umap.png",
                                               "pc_histogram/pc1_histogram.png")}
    embedded = [g is not None for g in grid]
    if not matplotlib_available() or embedding_backend() is None:
        print("semantic: matplotlib or an embedding backend is not installed here; "
              "fine_grained_structure and plot_semantic_classes_umap wrote their data and "
              f"embedded nothing; figures drawn: {drawn}", flush=True)

    rec = {"phase": "semantic", "seconds": time.perf_counter() - t_phase, **seconds,
           "n_stimuli": len(ids), "d_emb": spec["d_emb"], "taps": n_taps,
           "scores": {str(k): {r["layer"]: r["score"] for r in v} for k, v in runs.items()},
           "rdm_launches": launches, "rdm_shapes": [[*k, v] for k, v in sorted(shapes.items())],
           "db_rows": len(db_rows), "score_err": {str(k): v for k, v in score_err.items()},
           "tol": SEM_TOL, "recon_checked": spec["recon_check"],
           "pc1_high": pc["high_enriched"][:3], "pc1_low": pc["low_enriched"][:3],
           "n_animals": n_animals, "data_written": written, "drawn": drawn,
           "embedded": embedded, "matplotlib": matplotlib_available(),
           "embedding_backend": embedding_backend()}
    emit(rec)
    failures = []
    if launches != [n_taps + 1, n_taps + 1]:
        failures.append(f"launches {launches}, expected {n_taps + 1} per eval")
    if not db_ok:
        failures.append(f"results.db rows {db_rows}")
    if not max(score_err.values()) <= SEM_TOL:
        failures.append(f"scores off the CPU's by {score_err}")
    if not all(written.values()):
        failures.append(f"data not written: {written}")
    if failures:
        raise RuntimeError(f"semantic: {failures}")
    return {"launches": sum(launches), "shapes": shapes}


# ── the fifteenth slice: WordNet labels, the PCA analyses, the plotters ──

def wordnet_snapshot(wnids: list, seed: int, two_path_share: float) -> dict:
    """A synthetic hypernym snapshot ({wnid: root-first paths}) from a seed:
    a tree whose depth-1 to depth-5 nodes follow the Level-6 synset, which
    is drawn from SUPER_CATEGORIES' synsets, so depths 1–5 hold 2, 4, 8,
    16 and 32 synsets (``run.py``, as the JAX validator, trains on
    power-of-2 class counts only); paths 7–12 synsets deep (a 7-deep path
    ends at its Level-6 synset); ``two_path_share`` of the wnids with a
    second path one synset longer (an extra synset above the Level-6 one),
    so the longest and the shortest path differ from depth 6 on."""
    import numpy as np

    from visreps_tpu_torch.experiments.wordnet.make_semantic_labels import SUPER_CATEGORIES

    synsets = [s for syns in SUPER_CATEGORIES.values() for s in syns]
    rng = np.random.RandomState(seed)
    out = {}
    for wnid in wnids:
        c = rng.randint(len(synsets))
        cat = synsets[c]
        trunk = ["entity.n.01"] + [f"d{d}_{c % 2 ** d}.n.01" for d in range(1, 6)]
        length = rng.randint(7, 12)  # 7–11 synsets, 8–12 on a second path
        mids = [f"{cat.split('.')[0]}_m{j}_{rng.randint(3)}.n.01" for j in range(length - 8)]
        path = trunk + [cat] + mids + ([f"leaf_{wnid}.n.01"] if length > 7 else [])
        out[wnid] = [path]
        if rng.rand() < two_path_share:
            out[wnid].append(path[:6] + [f"alt_{c % 5}.n.01"] + path[6:])
    return out


def plain_samples(label_file: Path, images: Path) -> list:
    """(file name, class label) of every JPEG under the tree's labelled
    folders, by file name: the ImageNet dataset's sample order."""
    labels = json.loads(Path(label_file).read_text())
    rows = [(f.name, int(labels[d.name])) for d in Path(images).iterdir()
            if d.is_dir() and d.name in labels for f in d.iterdir()
            if f.suffix.lower() in (".jpeg", ".jpg")]
    return sorted(rows)


def plain_wordnet_csvs(paths: dict, wnid_of: list, samples: list) -> dict:
    """{depth: CSV lines} of the depth labels straight from the snapshot:
    each class's ancestor at the depth on its longest path (the first of
    equal length), ids by the sorted unique ancestors of all classes."""
    out = {}
    for depth in range(1, 8):
        anc = []
        for wnid in wnid_of:
            longest = paths[wnid][0]
            for p in paths[wnid][1:]:
                if len(p) > len(longest):
                    longest = p
            anc.append(longest[min(depth, len(longest) - 1)])
        ids = {a: i for i, a in enumerate(sorted(set(anc)))}
        out[depth] = ["image,pca_label"] + [f"{img},{ids[anc[label]]}" for img, label in samples]
    return out


def plain_semantic_csv(paths: dict, wnid_of: list, samples: list) -> list:
    """The semantic-category CSV lines straight from the snapshot: each
    class's Level-6 synset on its shortest path (the leaf where shorter)
    through SUPER_CATEGORIES, ids in the table's order."""
    from visreps_tpu_torch.experiments.wordnet.make_semantic_labels import SUPER_CATEGORIES

    category = {s: i for i, syns in enumerate(SUPER_CATEGORIES.values()) for s in syns}
    labels = []
    for wnid in wnid_of:
        shortest = paths[wnid][0]
        for p in paths[wnid][1:]:
            if len(p) < len(shortest):
                shortest = p
        labels.append(category[shortest[6] if len(shortest) > 6 else shortest[-1]])
    return ["image,pca_label"] + [f"{img},{labels[label]}" for img, label in samples]


def phase_wordnet(tmp: Path, meta: dict, cg: dict) -> dict:
    """The WordNet label source on the coarsegrain phase's 10,240-JPEG tree
    through its CLIs (``experiments/wordnet/``): a 1,000-wnid
    folder_labels.json whose first 32 entries are the tree's folders and a
    seeded hypernym snapshot for every wnid (``wordnet_snapshot``);
    ``make_wordnet_labels`` and ``make_semantic_labels`` with
    WORDNET_PATHS_JSON, each CSV equal line for line to a plain
    recomputation from the snapshot; ``run.main --mode train`` of CustomCNN
    on the depth whose class count is nearest WORDNET["target_k"]
    (``pca_labels_folder=wordnet``, 10 steps at batch 256, full width); and
    that checkpoint's NSD RSA eval with e2e's checks (its rows carry the
    folder). Returns the eval's run, the label CSVs and the class count."""
    from visreps_tpu_torch import run
    from visreps_tpu_torch.experiments.wordnet import make_semantic_labels, make_wordnet_labels

    spec = WORDNET
    t_phase = time.perf_counter()
    root = tmp / "wordnet"
    work = root / "work"
    work.mkdir(parents=True)
    data = cg["imagenet"]
    tree = json.loads(Path(data["label_file"]).read_text())
    wnid_of = sorted(tree, key=tree.get) + [f"n{90000000 + k:08d}"
                                            for k in range(spec["n_wnids"] - len(tree))]
    local = root / "imagenet_local"
    local.mkdir()
    (local / "folder_labels.json").write_text(json.dumps({w: k for k, w in enumerate(wnid_of)}))
    paths = wordnet_snapshot(wnid_of, spec["seed"], spec["two_path_share"])
    (root / "paths.json").write_text(json.dumps(paths))
    samples = plain_samples(local / "folder_labels.json", data["dataset_path"])
    env = {"IMAGENET_DATA_DIR": data["dataset_path"], "IMAGENET_LOCAL_DIR": local,
           "WORDNET_PATHS_JSON": root / "paths.json"}
    rec = {"phase": "wordnet", "n_wnids": len(wnid_of), "n_images": len(samples),
           "two_path_wnids": sum(len(p) > 1 for p in paths.values()),
           "path_lengths": sorted({len(q) for p in paths.values() for q in p})}
    seconds = {}
    cwd = os.getcwd()
    os.chdir(work)  # the CLIs' default outputs and pca_labels_folder are relative
    try:
        with environ(**env):
            written, seconds["wordnet_labels"] = timed(make_wordnet_labels.main, [])
            sem_csv, seconds["semantic_labels"] = timed(make_semantic_labels.main, [
                "--out", str(work / "semantic_categories.csv")])
        plain = plain_wordnet_csvs(paths, wnid_of, samples)
        ks = {depth: k for depth, (k, _) in written.items()}
        equal = {depth: Path(p).read_text().splitlines() == plain[depth]
                 for depth, (_, p) in written.items()}
        sem_equal = Path(sem_csv).read_text().splitlines() == plain_semantic_csv(
            paths, wnid_of, samples)
        mapping = Path(sem_csv.replace(".csv", "_mapping.txt")).read_text()
        rec["labels"] = {"classes_per_depth": ks, "csv_equal": equal,
                         "semantic_csv_equal": sem_equal,
                         "mapping_lines": len(mapping.splitlines())}
        if sorted(equal) != list(range(1, 8)) or not all(equal.values()) or not sem_equal \
                or "8 Super-Categories for ImageNet" not in mapping:
            raise RuntimeError(f"wordnet labels against the plain recomputation: {rec['labels']}")
        depth = min(ks, key=lambda d: (abs(ks[d] - spec["target_k"]), d))
        k = ks[depth]
        checkpoint_dir = root / "model_checkpoints"
        trainer, seconds["train"] = timed(run.main, [
            "--mode", "train", "--config", str(ROOT / "configs/train/base.json"), "--override",
            "pca_labels=true", f"pca_n_classes={k}", "pca_labels_folder=wordnet",
            f"batchsize={spec['batch']}", "num_epochs=1", "warmup_epochs=0",
            f"train_fraction={spec['train_fraction']}", "num_workers=16", "log_interval=2",
            "checkpoint_interval=1", "log_checkpoints=true", f"checkpoint_dir={checkpoint_dir}",
            f"dataset_path={data['dataset_path']}", f"label_file={local / 'folder_labels.json'}"])
    finally:
        os.chdir(cwd)
    losses = [h["loss"] for h in trainer.history]
    if len(losses) != spec["steps"] or not all(math.isfinite(v) for v in losses) \
            or trainer.model.fc3.out_features != k:
        raise RuntimeError(f"train on the WordNet labels: {len(losses)} steps, losses {losses}")
    if not (checkpoint_dir / f"cfg{k}a" / "checkpoint_epoch_1.pth").is_file():
        raise RuntimeError("train did not write epoch 1's checkpoint")
    rec["train"] = {"depth": depth, "classes": k, "steps": len(losses), "loss": losses,
                    "batch": spec["batch"], "loader_wait_s": trainer.loader_wait_s,
                    "ms_per_step_in_trainer": 1e3 * seconds["train"] / len(losses)}
    t0 = time.perf_counter()
    eval_run = run_eval("wordnet_eval", meta, [
        "load_model_from=checkpoint", f"cfg_id={k}", f"checkpoint_dir={checkpoint_dir}",
        "checkpoint_model=checkpoint_epoch_1.pth"],
        f"cfg_id = {k} AND epoch = 1 AND pca_labels_folder = 'wordnet'",
        lambda cfg_id, epoch: cfg_id == k and epoch == 1)
    seconds["eval"] = time.perf_counter() - t0
    rec.update(seconds=seconds, rdm_launches=eval_run["launches"],
               wall_s=time.perf_counter() - t_phase)
    emit(rec)
    csvs = [work / p for _, p in written.values()]  # the CLI's paths are relative to work
    return {"eval": eval_run, "csvs": csvs, "classes": k}


def planted_features(spec: dict):
    """A seeded (n_rows, d) f32 matrix made on the card: top directions of
    variance ``spectrum`` (then ``floor``) along a random orthogonal basis,
    on columns of scales in [0.5, 2) and offsets in [−1, 1); its
    correlation matrix's top 7 eigenvalues lie far apart, so the 6 PCs are
    well posed."""
    import torch

    n, d = spec["n_rows"], spec["d"]
    g = torch.Generator(device="cuda").manual_seed(spec["seed"])
    q, _ = torch.linalg.qr(torch.randn(d, d, generator=g, device="cuda"))
    s = torch.full((d,), spec["floor"], device="cuda")
    s[: len(spec["spectrum"])] = torch.tensor(spec["spectrum"], device="cuda")
    x = (torch.randn(n, d, generator=g, device="cuda") * s) @ q.T
    x = x * (0.5 + 1.5 * torch.rand(d, generator=g, device="cuda")) \
        + (2 * torch.rand(d, generator=g, device="cuda") - 1)
    return x.cpu().numpy()


def f64_pc_fit(features, spec: dict) -> dict:
    """The JAX script's fit in float64 on the card: the same numpy draw of
    fit rows, their mean and floored ddof-0 std, the covariance's top
    eigenvalues and eigenvectors, and every row's scores."""
    import numpy as np
    import torch

    n_fit = min(110000, len(features))
    idx = np.random.RandomState(42).choice(len(features), n_fit, replace=False)
    x = torch.from_numpy(features[idx]).cuda().double()
    mean, std = x.mean(0), x.std(0, correction=0).clamp_min(1e-8)
    z = (x - mean) / std
    del x
    vals, vecs = torch.linalg.eigh(z.T @ z / (n_fit - 1))
    del z
    k = spec["n_pcs"]
    # the next eigenvalue too, for the last PC's gap
    vals, top = vals.flip(0)[: k + 1], vecs.flip(1)[:, :k]
    scores = np.empty((len(features), k))
    for i in range(0, len(features), 65536):
        chunk = torch.from_numpy(features[i:i + 65536]).cuda().double()
        scores[i:i + 65536] = (((chunk - mean) / std) @ top).cpu().numpy()
    return {"eigenvalues": vals.cpu().numpy(), "eigenvectors": top.cpu().numpy(),
            "scores": scores}


def pole_checks(features, names, rows: list, spec: dict, require_pcs: bool) -> dict:
    """The card's fit (``fit_pcs``, ``compute_pc_scores``) and the CLI's
    pole CSV rows against ``f64_pc_fit``: eigenvalues within eig_rtol, the
    largest principal angle of the top subspaces, and for each PC whose
    f64 eigenvalue lies ≥ ``gap`` (relative) from its neighbours, scores
    within score_tol of its largest |score| up to sign, and each pole's
    image set up to that sign (a negated PC swaps low and high) and up to
    swaps between images whose f64 scores lie within twice the PC's
    card-vs-f64 error of the pole's edge. ``require_pcs``: fail when no PC
    is that well posed."""
    import numpy as np

    from visreps_tpu_torch.experiments.pca_analysis import pca_poles_images as poles

    k = spec["n_pcs"]
    fit = poles.fit_pcs(features, k, device="cuda")
    scores = poles.compute_pc_scores(features, k, device="cuda")
    ref = f64_pc_fit(features, spec)
    vals = fit["eigenvalues"].cpu().numpy().astype(np.float64)
    v64 = ref["eigenvalues"]
    eig_err = float((np.abs(vals - v64[:k]) / v64[:k]).max())
    # the largest principal angle from its sine (arccos of a cosine within
    # f32 rounding of 1 would read ≈ 1e-3 rad)
    q = np.linalg.qr(fit["eigenvectors"].cpu().numpy().astype(np.float64))[0]
    v = ref["eigenvectors"]
    angle = float(np.arcsin(min(1.0, np.linalg.norm(q - v @ (v.T @ q), 2))))
    gaps = [min((v64[j - 1] - v64[j]) if j else np.inf, v64[j] - v64[j + 1]) / v64[j]
            for j in range(k)]
    index = {n: i for i, n in enumerate(names)}
    by_pole = {}
    for r in rows:
        by_pole.setdefault((int(r["pc"]), r["pole"]), []).append(r["image_file"])
    checked, score_err, swaps, problems = [], 0.0, 0, []
    for j in range(k):
        if gaps[j] < spec["gap"]:
            continue
        checked.append(j + 1)
        s64 = ref["scores"][:, j]
        sign = 1.0 if float(np.dot(scores[:, j], s64)) >= 0 else -1.0
        diff = np.abs(sign * scores[:, j] - s64)
        err = float(diff.max() / np.abs(s64).max())
        score_err = max(score_err, err)
        order = np.argsort(s64)
        n = spec["n_poles"]
        want = {"low": order[:n], "high": order[-n:][::-1]}
        # the CLI's own fit's sign: its high pole lies high or low on the f64 PC
        cli = {p: [index[name] for name in by_pole[(j + 1, p)]] for p in ("low", "high")}
        cli_up = s64[cli["high"]].mean() > s64[cli["low"]].mean()
        for pole in ("low", "high"):
            mine = "low" if (pole == "low") == cli_up else "high"
            got = {index[name] for name in by_pole[(j + 1, mine)]}
            edge = s64[want[pole][-1]]
            for i in got ^ set(want[pole].tolist()):
                swaps += 1
                if abs(s64[i] - edge) > 2 * diff.max():
                    problems.append(f"PC {j + 1} {pole}: image {names[i]} is not a near tie")
    if not eig_err <= spec["eig_rtol"]:
        problems.append(f"eigenvalues {eig_err} off the f64 fit's")
    if not score_err <= spec["score_tol"]:
        problems.append(f"scores {score_err} off the f64 fit's")
    if len(rows) != 2 * k * spec["n_poles"] or (require_pcs and not checked):
        problems.append(f"{len(rows)} pole rows, PCs checked {checked}")
    return {"n_fit": fit["n_fit"], "fit_s": fit["seconds"], "eigenvalues": vals.tolist(), "eigenvalue_rel_err": eig_err,
            "eig_rtol": spec["eig_rtol"], "principal_angle_rad": angle,
            "relative_gaps": [float(g) for g in gaps], "pcs_checked": checked,
            "score_err": score_err, "score_tol": spec["score_tol"], "pole_swaps": swaps,
            "problems": problems}


def phase_pca_analysis(tmp: Path, cg: dict, wordnet_csvs: list) -> None:
    """experiments/pca_analysis and fig. 1a's schematic through their CLIs.
    ``pca_poles_images`` (on the card) on the coarsegrain phase's AlexNet
    fc2 features (10,240 × 4,096, in the reference's npz layout: ``fc2``,
    ``image_names``) and on a seeded 110,000 × 4,096 f32 matrix with a
    planted spectrum (the JAX script's full n_fit; ``planted_features``),
    each held to an f64 fit on the card (``pole_checks``), with the fit's
    seconds and its Gram and eigh times; ``pca_visualization`` on the
    coarsegrain features, eigenvectors and 4-class CSV (its sampled scores
    equal to a plain recomputation, bit for bit);
    ``visualize_class_distribution`` on the 64-class CSV and each WordNet
    CSV (counts equal to a plain count); the schematic's data. Nothing is
    drawn here: every data file must be written."""
    import numpy as np

    from visreps_tpu_torch.experiments.neurips_2025.fig1 import imagenet_pca_schematic
    from visreps_tpu_torch.experiments.pca_analysis import (
        pca_poles_images, pca_visualization, visualize_class_distribution)

    spec = PCA_POLES
    t_phase = time.perf_counter()
    root = tmp / "pca_analysis"
    work = root / "work"
    ds_dir = work / "datasets" / "obj_cls" / "imagenet"
    ds_dir.mkdir(parents=True)
    rec = {"phase": "pca_analysis"}
    feats = np.load(cg["features"])
    fc2, names = feats["features"], [str(n) for n in feats["image_ids"]]
    np.savez(ds_dir / "features_alexnet.npz", fc2=fc2, image_names=np.array(names))
    planted, rec["planted_make_s"] = timed(planted_features, spec)
    planted_names = [f"n{k % 32:08d}_p{k}.JPEG" for k in range(len(planted))]
    t0 = time.perf_counter()
    np.savez(ds_dir / "features_planted.npz", fc2=planted, image_names=np.array(planted_names))
    rec["planted_write_s"] = time.perf_counter() - t0
    meta_dir = root / "imagenet_meta"
    meta_dir.mkdir()
    wnids = sorted(json.loads(Path(cg["imagenet"]["label_file"]).read_text()))
    (meta_dir / "map_clsloc.txt").write_text(
        "".join(f"{w} {k + 1} class_{k}\n" for k, w in enumerate(wnids)))
    problems = []
    cwd = os.getcwd()
    os.chdir(work)  # the CLI reads and writes under datasets/obj_cls/ here
    try:
        with environ(IMAGENET_DATA_DIR=meta_dir):
            for name, x, row_names in (("alexnet", fc2, names),
                                       ("planted", planted, planted_names)):
                out, cli_s = timed(pca_poles_images.main, [
                    "--features_filename", f"features_{name}.npz",
                    "--n_poles", str(spec["n_poles"])])
                with open(work / out) as f:
                    rows = list(csv.DictReader(f))
                classes_ok = all(r["image_class"] == f"{int(r['image_class_id'][1:]) + 1} "
                                 f"class_{int(r['image_class_id'][1:])}" for r in rows)
                checks = pole_checks(x, row_names, rows, spec, require_pcs=name == "planted")
                rec[name] = {"shape": list(x.shape), "cli_s": cli_s,
                             "class_names_ok": classes_ok, **checks}
                problems += [f"{name}: {p}" for p in checks["problems"]]
                if not classes_ok:
                    problems.append(f"{name}: class names not from map_clsloc.txt")
    finally:
        os.chdir(cwd)
    del planted

    vis = root / "vis"
    eig = np.load(cg["eigenvectors"])
    (scores, labels), rec["visualization_s"] = timed(pca_visualization.main, [
        "--features", str(ds_dir / "features_alexnet.npz"),
        "--eigenvectors", str(cg["eigenvectors"]), "--labels_dir", str(cg["labels_dir"]),
        "--n_classes", "4", "--out_dir", str(vis)])
    idx = np.random.RandomState(42).choice(len(names), max(1, int(len(names) * 0.05)),
                                           replace=False)
    with open(Path(cg["labels_dir"]) / "n_classes_4.csv") as f:
        label_of = {r["image"]: int(r["pca_label"]) for r in csv.DictReader(f)}
    saved = np.load(vis / "pca_pc1pc2_4classes.npz")
    want = (fc2[idx] - eig["mean"]) @ eig["eigenvectors"][:, :4]
    rec["visualization"] = {
        "rows": len(scores), "scores_equal": bool(np.array_equal(saved["scores"], want)),
        "labels_equal": bool(np.array_equal(saved["labels"],
                                            [label_of[names[i]] for i in idx])),
        "densities_written": (vis / "pca_1d_distributions.json").is_file()}
    if not all(rec["visualization"][k] for k in ("scores_equal", "labels_equal",
                                                  "densities_written")):
        problems.append(f"pca_visualization: {rec['visualization']}")

    dist = {}
    for path in [Path(cg["labels_dir"]) / "n_classes_64.csv", *wordnet_csvs]:
        out = root / "distribution" / f"{path.parent.name}_{path.stem}.png"
        counts = visualize_class_distribution.main(["--labels", str(path), "--out", str(out)])
        with open(path) as f:
            plain = sorted(Counter(r["pca_label"] for r in csv.DictReader(f)).values(),
                           reverse=True)
        data = json.loads(out.with_suffix(".json").read_text())
        dist[f"{path.parent.name}/{path.name}"] = ok = (
            counts.tolist() == plain == data["counts"])
        if not ok:
            problems.append(f"class distribution of {path}: {counts.tolist()[:8]}")
    rec["class_distribution_equal"] = dist

    schematic = root / "fig1" / "schematic_imagenet_pca.png"
    data, rec["schematic_s"] = timed(imagenet_pca_schematic.main, ["--out", str(schematic)])
    saved = np.load(schematic.with_suffix(".npz"))
    rec["schematic"] = {"points": list(saved["points"].shape),
                        "quadrants": np.bincount(saved["quadrant"]).tolist(),
                        "finite": bool(np.isfinite(saved["points"]).all())}
    if saved["points"].shape != (10_000, 2) or not rec["schematic"]["finite"] \
            or sum(rec["schematic"]["quadrants"]) != 10_000:
        problems.append(f"schematic data {rec['schematic']}")
    rec["drawn"] = sorted(str(p.relative_to(root)) for p in root.rglob("*.png"))
    rec["wall_s"] = time.perf_counter() - t_phase
    rec["problems"] = problems
    emit(rec)
    if problems:
        raise RuntimeError(f"pca_analysis: {problems}")


PLOTTER_REGIONS = {  # tests/test_plotters.py's layout
    "nsd": ["early visual stream", "ventral visual stream", "V1", "V2", "V3", "hV4", "FFA", "PPA"],
    "nsd_synthetic": ["early visual stream", "ventral visual stream"],
    "tvsd": ["V1", "V4", "IT"],
    "things-behavior": ["N/A"],
}


def seed_plotter_db(path: Path) -> int:
    """tests/test_plotters.py's seeded results.db through the port's
    ``save_results`` (PLOTTERS["subjects"] a dataset; THINGS' one 'N/A'):
    every dataset and region, 2 seeds, the alexnet and
    clip label folders at cfg 2–64 (epoch 20), the 1000-class baseline and
    the untrained model, 40 bootstrap scores a row. Returns the runs."""
    import numpy as np

    from visreps_tpu_torch.core.config import Config
    from visreps_tpu_torch.core.db import save_results

    rng = np.random.RandomState(PLOTTERS["seed"])
    subjects = {nd: [str(s) for s in range(n)] for nd, n in PLOTTERS["subjects"].items()}
    subjects["things-behavior"] = ["N/A"]
    n = 0

    def save(cfg_id, folder, epoch, region, subj, seed, score, nd, pca=True):
        save_results([{"layer": "conv5_post", "compare_method": "spearman", "score": score,
                       "ci_low": score - 0.03, "ci_high": score + 0.03, "analysis": "rsa",
                       "layer_selection_scores": [],
                       "bootstrap_scores": list(rng.uniform(score - 0.04, score + 0.04, 40))}],
                     Config({"seed": seed, "epoch": epoch, "region": region, "subject_idx": subj,
                             "neural_dataset": nd, "cfg_id": cfg_id, "pca_labels": pca,
                             "pca_n_classes": cfg_id if pca else None,
                             "pca_labels_folder": folder, "checkpoint_dir": f"ckpt_{folder}",
                             "analysis": "rsa", "compare_method": "spearman",
                             "reconstruct_from_pcs": False, "pca_k": 1,
                             "model_name": "CustomCNN"}), db_path=path)

    for nd, regions in PLOTTER_REGIONS.items():
        for region in regions:
            for subj in subjects[nd]:
                for seed in (1, 2):
                    for arch in ("alexnet", "clip"):
                        for cfg_id in (2, 4, 8, 16, 32, 64):
                            save(cfg_id, f"pca_labels_{arch}", 20, region, subj, seed,
                                 0.2 + 0.002 * cfg_id + 0.01 * seed, nd)
                            n += 1
                    save(1000, "imagenet1k", 20, region, subj, seed, 0.31, nd, pca=False)
                    save(1000, "imagenet1k", 0, region, subj, seed, 0.05, nd, pca=False)
                    n += 2
    return n


def plain_best(conn, nd, region, folder, cfg_id, method, epoch, analysis) -> list:
    """[(run_id, seed, subject, score)] of one condition's best row per
    (seed, subject), sorted by (seed, subject): sqlite3 and Python only."""
    q = ("SELECT run_id, seed, subject_idx, score FROM results WHERE neural_dataset = ? "
         "AND region = ? AND pca_labels_folder = ? AND cfg_id = ? AND compare_method = ? "
         "AND analysis = ? AND reconstruct_from_pcs = 0")
    params = [nd, region, folder, str(cfg_id), method, analysis]
    if epoch is not None:
        q += " AND epoch = ?"
        params.append(str(epoch))
    best = {}
    for run_id, seed, subj, score in conn.execute(q, params).fetchall():
        if subj is not None and score is not None and (
                (seed, subj) not in best or score > best[(seed, subj)][3]):
            best[(seed, subj)] = (run_id, seed, subj, score)
    return [best[key] for key in sorted(best)]


def plain_summary(conn, nd, region, folder, cfg_id, method, epoch, analysis) -> list:
    """[mean, ci_low, ci_high] of one condition: the bootstrap percentiles
    of the runs' element-wise mean distribution, else (or where they do
    not bracket the mean) ±1.96 SEM of the seed means, NaN with one seed."""
    import numpy as np

    best = plain_best(conn, nd, region, folder, cfg_id, method, epoch, analysis)
    if not best:
        return [math.nan] * 3
    mean = math.fsum(b[3] for b in best) / len(best)
    ids = [b[0] for b in best]
    dists = [json.loads(s) for (s,) in conn.execute(
        f"SELECT scores FROM bootstrap_distributions WHERE run_id IN "
        f"({','.join('?' * len(ids))}) AND compare_method = ?", [*ids, method])]
    lo = hi = math.nan
    if dists:
        n = min(len(d) for d in dists)
        avg = [math.fsum(d[i] for d in dists) / len(dists) for i in range(n)]
        lo, hi = float(np.percentile(avg, 2.5)), float(np.percentile(avg, 97.5))
    if math.isnan(lo) or lo > mean or hi < mean:
        by_seed = {}
        for _, seed, _, score in best:
            by_seed.setdefault(seed, []).append(score)
        means = [math.fsum(v) / len(v) for _, v in sorted(by_seed.items())]
        if len(means) > 1:
            mu = math.fsum(means) / len(means)
            sem = math.sqrt(math.fsum((m - mu) ** 2 for m in means) / (len(means) - 1)) \
                / math.sqrt(len(means))
            lo, hi = mean - 1.96 * sem, mean + 1.96 * sem
        else:
            lo = hi = math.nan
    return [mean, lo, hi]


def plain_subjects(conn, nd, region, folder, cfg_id, method, epoch, analysis) -> dict:
    """{subject: mean over seeds of its best rows}, subjects sorted."""
    by = {}
    for _, _, subj, score in plain_best(conn, nd, region, folder, cfg_id, method, epoch,
                                        analysis):
        by.setdefault(subj, []).append(score)
    return {s: math.fsum(v) / len(v) for s, v in sorted(by.items())}


def plain_coarseness(conn, dcfg: dict, model: str) -> tuple:
    """Both coarseness figures' series of one dataset config, from
    ``plain_summary`` and ``plain_subjects``."""
    nd, analysis = dcfg["neural_dataset"], dcfg["analysis"]
    method, cfgs = dcfg["compare_method"], (2, 4, 8, 16, 32, 64)
    bars, boxes = [], []
    for region in dcfg["regions"]:
        args = (nd, region)
        un = plain_summary(conn, *args, "imagenet1k", 1000, method, 0, analysis)
        x0 = 1.5 if not math.isnan(un[0]) else 0.0
        panel = [("Untrained", 0.0, un)] if x0 else []
        panel += [(str(c), x0 + i, plain_summary(conn, *args, f"pca_labels_{model}", c, method,
                                                 20, analysis)) for i, c in enumerate(cfgs)]
        panel.append(("1000", x0 + 7, plain_summary(conn, *args, "imagenet1k", 1000, method, 20,
                                                    analysis)))
        bars.append({"region": region, "label": [p[0] for p in panel],
                     "x": [p[1] for p in panel], "mean": [p[2][0] for p in panel],
                     "ci_low": [p[2][1] for p in panel], "ci_high": [p[2][2] for p in panel]})
        subj = {str(c): plain_subjects(conn, *args, f"pca_labels_{model}", c, method, 20,
                                       analysis) for c in cfgs}
        subj["1K"] = plain_subjects(conn, *args, "imagenet1k", 1000, method, 20, analysis)
        labels = [lab for lab, v in subj.items() if v]
        if len(labels) < 2:
            boxes.append({"region": region, "insufficient": True})
            continue
        common = sorted(set.intersection(*(set(subj[lab]) for lab in labels)))
        n_coarse = len(labels) - ("1K" in labels)
        boxes.append({"region": region, "insufficient": False, "labels": labels,
                      "x": [n_coarse + 0.7 if lab == "1K" else float(i)
                            for i, lab in enumerate(labels)],
                      "subjects": common,
                      "scores": [[subj[lab][s] for s in common] for lab in labels]})
    return bars, boxes


def plain_architectures(conn, nd: str, region: str, method: str, epoch: int) -> dict:
    """plot_architectures' data: the label sources with coarse rows, each
    bar's mean with its paired t-test against the 1000-class scores (the
    t statistic by its formula, p from Student's t), the 1000-class mean,
    and the per-subject scores at each source's best coarse cfg."""
    from scipy.stats import t as student_t

    cfgs = (2, 4, 8, 16, 32, 64)
    models = {"alexnet": "AlexNet", "vit": "ViT", "clip": "CLIP", "dino": "DINO"}
    archs = [a for a in models if any(plain_best(conn, nd, region, f"pca_labels_{a}", c, method,
                                                 None, "rsa") for c in cfgs)]
    if not archs:
        return {}
    base = [b[3] for b in plain_best(conn, nd, region, "imagenet1k", 1000, method, epoch, "rsa")]
    bars = []
    for c in cfgs:
        for a in archs:
            scores = [b[3] for b in plain_best(conn, nd, region, f"pca_labels_{a}", c, method,
                                               epoch, "rsa")]
            if not scores:
                continue
            p = None
            if base and len(scores) == len(base) and len(scores) > 1:
                d = [x - y for x, y in zip(scores, base)]
                mu = math.fsum(d) / len(d)
                sd = math.sqrt(math.fsum((v - mu) ** 2 for v in d) / (len(d) - 1))
                p = float(2 * student_t.sf(abs(mu / (sd / math.sqrt(len(d)))), len(d) - 1)) \
                    if sd > 0 else math.nan
            bars.append({"architecture": a, "n_classes": c,
                         "mean": math.fsum(scores) / len(scores), "p": p})
    series, labels = [], []
    for a in archs:
        best = None
        for c in cfgs:
            sm = plain_subjects(conn, nd, region, f"pca_labels_{a}", c, method, epoch, "rsa")
            if sm and (best is None or math.fsum(sm.values()) / len(sm) > best[0]):
                best = (math.fsum(sm.values()) / len(sm), c, sm)
        if best:
            series.append(list(best[2].values()))
            labels.append(f"{models[a]}\n(best: {best[1]})")
    sm = plain_subjects(conn, nd, region, "imagenet1k", 1000, method, epoch, "rsa")
    if sm:
        series.append(list(sm.values()))
        labels.append("ImageNet-1K")
    return {"architectures": archs, "bars": bars,
            "baseline_1k": math.fsum(base) / len(base) if base else None,
            "labels": labels, "series": series}


def _nan(v):
    """A JSON value with null read as NaN."""
    if isinstance(v, list):
        return [_nan(x) for x in v]
    return math.nan if v is None else v


def phase_plotters(tmp: Path, wn: dict) -> None:
    """The results.db plotters (``visreps_tpu_torch/plotters/``) through their
    CLIs, on two databases: a seeded one in tests/test_plotters.py's layout
    written through the port's ``save_results`` (``seed_plotter_db``) and
    this run's own results.db, which holds the WordNet checkpoint's rows.
    The four ``plot_coarseness`` CLIs (NSD with both region presets and
    with ``--analysis encoding_score``, NSD-Synthetic, THINGS, TVSD) and
    ``plot_architectures``: every JSON series equal to a plain ``sqlite3``
    + numpy recomputation (``plain_coarseness``, ``plain_architectures``)
    within 1e-12 relative, with keys, labels, x positions and NaN places
    exact; and ``plotter_utils``' query and summary of the WordNet rows
    against the same recomputation. Nothing is drawn here."""
    from visreps_tpu_torch.plotters import plot_architectures
    from visreps_tpu_torch.plotters import plotter_utils as pu
    from visreps_tpu_torch.plotters.nsd import plot_coarseness as nsd
    from visreps_tpu_torch.plotters.nsd_synthetic import plot_coarseness as synthetic
    from visreps_tpu_torch.plotters.things import plot_coarseness as things
    from visreps_tpu_torch.plotters.tvsd import plot_coarseness as tvsd

    rtol = PLOTTERS["rtol"]
    t_phase = time.perf_counter()
    root = tmp / "plotters"
    root.mkdir()
    seeded = root / "seeded.db"
    n_runs, seed_s = timed(seed_plotter_db, seeded)
    rec = {"phase": "plotters", "seeded_runs": n_runs, "seed_db_s": seed_s, "checks": {}}
    streams = ["early visual stream", "ventral visual stream"]
    fine = nsd.REGION_PRESETS["finegrained"]["regions"]
    clis = [  # (name, module, argv, dataset config of the plain recomputation, label source)
        ("nsd_streams", nsd, ["--regions", "streams"],
         {"neural_dataset": "nsd", "regions": streams, "analysis": "rsa",
          "compare_method": "spearman"}, "alexnet"),
        ("nsd_finegrained", nsd, ["--pca_labels", "clip", "--regions", "finegrained"],
         {"neural_dataset": "nsd", "regions": fine, "analysis": "rsa",
          "compare_method": "spearman"}, "clip"),
        ("nsd_encoding", nsd, ["--analysis", "encoding_score"],
         {"neural_dataset": "nsd", "regions": streams, "analysis": "encoding_score",
          "compare_method": "pearson"}, "alexnet"),
        ("nsd_synthetic", synthetic, [],
         {"neural_dataset": "nsd_synthetic", "regions": streams, "analysis": "rsa",
          "compare_method": "spearman"}, "alexnet"),
        ("things", things, [],
         {"neural_dataset": "things-behavior", "regions": ["N/A"], "analysis": "rsa",
          "compare_method": "spearman"}, "alexnet"),
        ("tvsd", tvsd, [],
         {"neural_dataset": "tvsd", "regions": ["V1", "V4", "IT"], "analysis": "rsa",
          "compare_method": "spearman"}, "alexnet"),
    ]
    problems = []
    for db_name, db_path in (("seeded", seeded), ("run", Path(os.environ["VISREPS_RESULTS_DB"]))):
        conn = sqlite3.connect(str(db_path))
        out = root / db_name
        checks = {}
        for name, module, argv, dcfg, model in clis:
            (bars_png, boxes_png), s = timed(module.main, [
                *argv, "--out-dir", str(out / name), "--db", str(db_path)])
            bars = json.loads(Path(bars_png).with_suffix(".json").read_text())
            want_bars, want_boxes = plain_coarseness(conn, dcfg, model)
            got = [{k: p[k] for k in ("region", "label", "x", "mean", "ci_low", "ci_high")}
                   for p in bars]
            ok = [g["region"] for g in got] == [w["region"] for w in want_bars] and all(
                g["label"] == w["label"] and g["x"] == w["x"]
                and all(close_series(_nan(g[k]), w[k], rtol) for k in ("mean", "ci_low",
                                                                       "ci_high"))
                for g, w in zip(got, want_bars))
            if boxes_png is None:  # THINGS has no subjects
                ok &= name == "things"
            else:
                boxes = json.loads(Path(boxes_png).with_suffix(".json").read_text())
                ok &= len(boxes) == len(want_boxes) and all(
                    g["region"] == w["region"] and g["insufficient"] == w["insufficient"]
                    and (w["insufficient"] or (
                        g["labels"] == w["labels"] and g["x"] == w["x"]
                        and g["subjects"] == w["subjects"]
                        and close_series(_nan(g["scores"]), w["scores"], rtol)))
                    for g, w in zip(boxes, want_boxes))
            finite = sum(math.isfinite(v) for p in want_bars for v in p["mean"])
            checks[name] = {"equal": bool(ok), "finite_bars": finite, "s": s}
            if not ok:
                problems.append(f"{db_name}/{name}: series differ from the recomputation")
        got, s = timed(plot_architectures.main, [
            "--dataset", "nsd", "--region", "ventral visual stream", "--out-dir",
            str(out / "architectures"), "--db", str(db_path)])
        want = plain_architectures(conn, "nsd", "ventral visual stream", "spearman", 20)
        if got is None:
            ok = want == {}
        else:
            bars = json.loads(Path(got["bars"]).with_suffix(".json").read_text())
            boxes = json.loads(Path(got["boxes"]).with_suffix(".json").read_text())
            ok = got["architectures"] == want["architectures"] and [
                (b["architecture"], b["n_classes"]) for b in bars["bars"]] == [
                (b["architecture"], b["n_classes"]) for b in want["bars"]] and all(
                close_series([g["mean"], _nan(g["p"])], [w["mean"], _nan(w["p"])], rtol)
                and g["star"] == (w["p"] is not None and w["p"] < 0.01)
                for g, w in zip(bars["bars"], want["bars"])) and close_series(
                _nan(bars["baseline_1k"]), _nan(want["baseline_1k"]), rtol) \
                and boxes["labels"] == want["labels"] and len(boxes["series"]) == len(
                want["series"]) and all(close_series(g, w, rtol)
                                        for g, w in zip(boxes["series"], want["series"]))
        checks["architectures"] = {"equal": bool(ok), "s": s,
                                   "sources": want.get("architectures", [])}
        if not ok:
            problems.append(f"{db_name}/architectures: series differ from the recomputation")
        rec["checks"][db_name] = checks
        conn.close()

    run_db = Path(os.environ["VISREPS_RESULTS_DB"])
    with sqlite3.connect(str(run_db)) as conn:
        wordnet = {}
        for region in NSD_REGIONS[: E2E["n_regions"]]:
            args = ("nsd", region, "wordnet", wn["classes"], "spearman", 1, "rsa")
            best = pu.query_best_scores(*args, db_path=run_db)
            summary = pu.get_condition_summary(*args, db_path=run_db)
            plain = plain_best(conn, *args)
            ok = [(r, s) for r, _, _, s in plain] == list(zip(best["run_id"].tolist(),
                                                              best["score"].tolist())) \
                and len(plain) == E2E["n_subjects"] and close_series(
                    [summary["mean"], summary["ci_low"], summary["ci_high"]],
                    plain_summary(conn, *args), rtol) \
                and close_series(list(pu.get_subject_scores(*args, db_path=run_db).values()),
                                 list(plain_subjects(conn, *args).values()), rtol)
            wordnet[region] = {"equal": bool(ok), "mean": summary["mean"],
                               "ci": [summary["ci_low"], summary["ci_high"]]}
            if not ok:
                problems.append(f"wordnet rows of {region}: queries differ")
    rec["wordnet_rows"] = wordnet
    rec["drawn"] = sorted(str(p.relative_to(root)) for p in root.rglob("*.png"))
    rec["wall_s"] = time.perf_counter() - t_phase
    rec["problems"] = problems
    emit(rec)
    if problems:
        raise RuntimeError(f"plotters: {problems}")


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
        rsa_runs.append(phase_retain(meta, rsa_runs[0]))
        phase_procs(meta, rsa_runs[0], tmp)
        checkpoint_dir, train_data = phase_train(tmp)
        phase_train_step()
        phase_train_families()
        rsa_runs.append(phase_e2e_ckpt(meta, checkpoint_dir))
        rsa_runs.append(phase_train_resume(meta, tmp, train_data))
        phase_trace(meta, tmp, train_data)
        phase_runners(tmp, train_data)
        phase_decode(tmp)
        rsa_runs.append(phase_things(tmp))
        rsa_runs.append(phase_tvsd(tmp))
        rsa_runs.append(phase_nsd_synthetic(tmp, rsa_runs[0]["results"]))
        rsa_runs.append(phase_scripts(meta, tmp, rsa_runs[0]))
        rsa_runs.append(phase_parallel(meta, tmp, rsa_runs[0]))
        rsa_runs.append(phase_ref_ckpt(meta, tmp))
        # VGG16's eval runs at 37,000 NSD stimuli in nsd73k_vgg16 below
        rsa_runs.extend(phase_pretrained(meta, tmp, name) for name in ("ResNet50", "ViTBase"))
        rsa_runs.extend(phase(meta, rsa_runs[0])
                        for phase in (phase_kendall, phase_dense_boot, phase_pca))
        rsa_runs.append(phase_cross_model(tmp))
        phase_analyses(tmp, train_data)
        meta73 = nsd73k_fixture(tmp)
        rsa_runs.append(phase_nsd73k_vgg16(meta73, tmp))
        phase_nsd73k_encoding(meta73)
        shutil.rmtree(Path(meta73["stimuli"]).parent)
        phase_encoding_sharded(tmp, phase_encoding(tmp))
        cg = phase_coarsegrain(meta, tmp)
        rsa_runs.append(cg["eval"])
        cg_rsa = phase_cg_benefits(meta, tmp, cg)
        rsa_runs.append(cg_rsa)
        recon = phase_reconstruction(meta, tmp, train_data)
        rsa_runs.extend(recon["runs"])
        binary = phase_binary_pc_rsa(meta, tmp, cg["eigenvectors"])
        rsa_runs.append(binary)
        phase_figures(tmp, recon, binary["csv"], cg_rsa["csv"])
        rep = phase_representation(tmp, train_data, checkpoint_dir, meta)
        rsa_runs.append(rep)
        rsa_runs.append(phase_semantic(tmp, meta, rep))
        del rep
        wn = phase_wordnet(tmp, meta, cg)
        rsa_runs.append(wn["eval"])
        phase_pca_analysis(tmp, cg, wn["csvs"])
        phase_plotters(tmp, wn)
        phase_path(sum((r["shapes"] for r in rsa_runs), Counter()), records)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_encoding_check()
    phase_encoding_delta()
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
