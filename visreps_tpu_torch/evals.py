"""NSD RSA evaluation (port of ``visreps_tpu/evals.py:54-66, 96-123,
143-302, 397-873`` for ``neural_dataset=nsd``, ``analysis=rsa``), of an
untrained torchvision-architecture model or of a checkpoint.

The two-phase protocol of the reference:

  * phase 1 — per (region, subject), pick the layer whose SRP-activation
    RDM best matches the neural RDM on a seed-42 subsample of
    ``n_select`` train stimuli;
  * phase 2 — exact (full-resolution) taps of the selected layers on the
    shared test stimuli, one RDM per unique layer;
  * scoring — average-tie Spearman point score of model vs neural RDM
    per pair, plus 1000 × 90 % subsample bootstrap CIs (grouped over
    pairs), saved to results.db.

Every RDM goes through ``ops.rdm.compute_rdm`` — the Hopper kernel on
the card. Configurations outside this slice raise NotImplementedError
naming the ROADMAP.md item that ports them.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from visreps_tpu_torch.analysis.rsa import select_best_layer, select_scores_multipair
from visreps_tpu_torch.core.config import Config, get_seed_letter
from visreps_tpu_torch.core.db import save_results
from visreps_tpu_torch.core.logging import Timer, rprint
from visreps_tpu_torch.data.loader import make_stimuli_loader
from visreps_tpu_torch.data.neural import load_all_nsd_data
from visreps_tpu_torch.data.transforms import get_transform
from visreps_tpu_torch.device import resolve_device
from visreps_tpu_torch.models.extractor import configure_feature_extractor
from visreps_tpu_torch.models.zoo import TORCHVISION_RETURN_NODES, checkpoint_path, load_model
from visreps_tpu_torch.ops.bootstrap import bootstrap_indices, grouped_scoring, percentile_ci
from visreps_tpu_torch.ops.rdm import compute_rdm

#: Wall-clock seconds of the last eval's phases: model_load_s,
#: data_load_s, extraction_s (of which extraction_loader_s waited on the
#: host loader), phase1_selection_s, phase2_extract_s,
#: scoring_bootstrap_s. Rewritten by every eval() call.
LAST_PHASE_TIMES: Dict[str, float] = {}


def _load_cfg(cfg: Config) -> Config:
    """The eval config merged over the checkpoint's training config: the
    epoch comes from the checkpoint's file name, and the training
    config's mode, exp_name, lr_scheduler and n_classes are dropped."""
    with open(Path(checkpoint_path(cfg)).parent / "config.json") as f:
        base = Config(json.load(f))
    base.epoch = int(cfg.checkpoint_model.split("_")[-1].split(".")[0])
    for k in ("mode", "exp_name", "lr_scheduler", "n_classes"):
        base.pop(k, None)
    return base.merge(cfg)


def _listify(val) -> list:
    return list(val) if isinstance(val, list) else [val]


def _neural_tensor(responses: dict, ids) -> np.ndarray:
    arr = np.stack([responses[sid] for sid in ids if sid in responses]).astype(np.float32)
    return arr.reshape(arr.shape[0], -1)


def _selection_plan(neural, subjects, regions, stimuli, n_select):
    """Seed-42 phase-1 subsample per (region, subject), in draw order.

    Extraction order is the loader's sorted-key order; a pair's matched
    stimuli are that order filtered to its train ids, and the subsample
    is RandomState(42).choice over the matched length (the reference's
    protocol). Returns {(region, subject): [stimulus ids]}.
    """
    order = [str(k) for k in sorted(stimuli.keys())]
    plan = {}
    for region in regions:
        for subj in subjects:
            targets = neural[region][subj]["train"]
            matched = [k for k in order if k in targets]
            n_train = len(matched)
            if n_select is not None and n_select < n_train:
                sel = np.random.RandomState(42).choice(n_train, size=n_select, replace=False)
            else:
                sel = np.arange(n_train)
            plan[(region, subj)] = [matched[i] for i in sel]
    return plan


def _check_slice(cfg) -> None:
    """Raise for configurations this port does not cover yet."""
    def missing(what, item):
        raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md, {item!r})")

    dataset = cfg.get("neural_dataset", "nsd").lower()
    if dataset in ("tvsd", "nsd_synthetic", "things-behavior"):
        missing(f"neural_dataset={dataset}", "THINGS/TVSD/NSD-synthetic")
    if dataset != "nsd":
        raise ValueError(f"Unsupported neural_dataset={dataset!r}")
    analysis = cfg.get("analysis", "rsa").lower()
    if analysis == "encoding_score":
        missing("analysis=encoding_score", "Encoding")
    if analysis != "rsa":
        raise ValueError(f"Unknown analysis method: {analysis}")
    method = cfg.get("compare_method", "spearman").lower()
    if method != "spearman":
        missing(f"compare_method={method} scoring", "Pearson/Kendall scoring")
    if cfg.get("bootstrap_exact_ties", "auto") is False:
        missing("bootstrap_exact_ties=false (dense-rank bootstrap)", "Pearson/Kendall scoring")
    if cfg.get("reconstruct_from_pcs"):
        missing("reconstruct_from_pcs", "Analysis remainder")
    if (cfg.get("load_model_from") != "checkpoint"
            and cfg.get("model_name", "AlexNet") not in TORCHVISION_RETURN_NODES):
        missing(f"model_name={cfg.get('model_name')}", "Remaining models")


def eval(cfg: Config, device: str | torch.device | None = None) -> List[Dict]:
    """Run the NSD RSA eval; returns one result dict per (region, subject).

    ``device`` defaults to CUDA (raising when there is none); pass
    ``"cpu"`` to run on the CPU with the kernel's plain version.
    """
    device = resolve_device(device)
    _check_slice(cfg)
    verbose = cfg.get("verbose", False)
    LAST_PHASE_TIMES.clear()

    if cfg.get("load_model_from") == "checkpoint":
        cfg = _load_cfg(cfg)
    else:
        cfg.epoch = -1
        cfg.cfg_id = "pretrained" if cfg.get("pretrained_dataset") == "imagenet1k" else "untrained"
        cfg.return_nodes = TORCHVISION_RETURN_NODES[cfg.get("model_name", "AlexNet")]
    subjects = _listify(cfg.subject_idx)
    regions = _listify(cfg.region)
    seed_letter = get_seed_letter(cfg.seed) if isinstance(cfg.seed, int) else "?"
    rprint(f"\n  RSA eval | cfg{cfg.cfg_id}{seed_letter} epoch {cfg.epoch} | NSD | "
           f"{len(subjects)} subjects x {len(regions)} regions | seed {cfg.seed} | {device}\n",
           style="info")

    timer = Timer()
    model = load_model(cfg, device=device)
    extractor = configure_feature_extractor(cfg, model, device=device, verbose=verbose)
    LAST_PHASE_TIMES["model_load_s"] = timer.mark("model_load")

    all_data = load_all_nsd_data(cfg, subjects=subjects, regions=regions)
    LAST_PHASE_TIMES["data_load_s"] = timer.mark("data_load")
    stimuli = all_data["stimuli"]
    rprint(f"  {len(subjects)} subjects x {len(regions)} regions, {len(stimuli)} stimuli, "
           f"{len(all_data['shared_test_ids'])} shared test IDs", style="success")

    transform = get_transform("imgnet", normalize=not cfg.get("uint8_transfer", False))
    dl = make_stimuli_loader(stimuli, transform, cfg.batchsize, cfg.get("num_workers", 16))
    store = cfg.get("acts_store", "auto")
    if store == "auto":
        store = "device" if device.type == "cuda" else "host"
    acts, ids = extractor.get_activations(dl, store=store)
    extractor.free_projection_cache()
    LAST_PHASE_TIMES["extraction_s"] = timer.mark("extraction")
    LAST_PHASE_TIMES["extraction_loader_s"] = extractor.last_extract_times["loader_s"]
    rprint("  Activations extracted once for all subjects/regions", style="success")
    return _eval_rsa(cfg, extractor, acts, ids, all_data, subjects, regions, verbose)


def _eval_rsa(cfg, extractor, acts, ids, all_data, subjects, regions, verbose) -> List[Dict]:
    """Two-phase RSA over the extracted SRP store ``acts``."""
    method = cfg.get("compare_method", "spearman").lower()
    bootstrap = cfg.get("bootstrap", False)
    n_bootstrap = cfg.get("n_bootstrap", 1000)
    exact_sel = bool(cfg.get("selection_exact_ties", False))
    neural = all_data["neural"]
    shared_test_ids = all_data["shared_test_ids"]
    stimuli = all_data["stimuli"]
    device = extractor.device
    tap_names = list(acts)
    id_pos = {str(k): i for i, k in enumerate(ids)}
    plan = _selection_plan(neural, subjects, regions, stimuli, cfg.get("n_select", 1000))

    # ── Phase 1: per-(region, subject) layer selection (SRP) ──
    t0 = time.perf_counter()
    rprint("\n  Phase 1: Per-subject layer selection", style="info")
    best: Dict = {r: {} for r in regions}
    sel_scores: Dict = {r: {} for r in regions}

    def record(region, subj, scores, n_used):
        layer = max(scores, key=lambda l: scores[l] if scores[l] == scores[l] else -np.inf)
        best[region][subj] = layer
        sel_scores[region][subj] = [{"layer": l, "score": s} for l, s in scores.items()]
        if verbose:
            rprint(f"    {region} subj {subj}: {layer} ({scores[layer]:.4f}), "
                   f"{n_used} stimuli for selection", style="info")

    def take(rows) -> dict:
        ix = torch.as_tensor(rows)
        return {l: acts[l][ix.to(acts[l].device)].to(device) for l in tap_names}

    for subj in subjects:
        rows = {r: [id_pos[k] for k in plan[(r, subj)]] for r in regions}
        targets = {r: _neural_tensor(neural[r][subj]["train"], plan[(r, subj)]) for r in regions}
        if all(rows[r] == rows[regions[0]] for r in regions):
            # One set of L model RDMs scored against all R neural RDMs.
            neural_rdms = torch.stack([
                compute_rdm(torch.as_tensor(targets[r], device=device)) for r in regions])
            vals = select_scores_multipair(list(take(rows[regions[0]]).values()),
                                           neural_rdms, method, exact_sel).cpu()
            for region, row in zip(regions, vals.tolist()):
                record(region, subj, dict(zip(tap_names, row)), len(rows[region]))
        else:
            for region in regions:
                record(region, subj, select_best_layer(take(rows[region]), targets[region],
                                                       method, exact_sel), len(rows[region]))
    del acts
    LAST_PHASE_TIMES["phase1_selection_s"] = time.perf_counter() - t0
    rprint("  Freed bulk SRP activations", style="success")

    # ── Phase 2: exact taps of the selected layers on the shared test set ──
    t0 = time.perf_counter()
    rprint("\n  Phase 2: Test evaluation", style="info")
    unique_layers = sorted({l for rl in best.values() for l in rl.values()})
    test_stimuli = {sid: stimuli[sid] for sid in shared_test_ids if sid in stimuli}
    dl_test = make_stimuli_loader(test_stimuli, get_transform("imgnet"),
                                  min(int(cfg.batchsize), 256), cfg.get("num_workers", 16))
    rprint(f"  Re-extracting {len(unique_layers)} unique layers (one pass) over "
           f"{len(test_stimuli)} test stimuli...", style="info")
    exact, _ = extractor.extract_layers_exact(dl_test, unique_layers, shared_test_ids)
    model_rdms = {}
    for layer in unique_layers:
        model_rdms[layer] = compute_rdm(exact.pop(layer))
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # bill the queued RDM launches to phase 2
    LAST_PHASE_TIMES["phase2_extract_s"] = time.perf_counter() - t0

    # ── Scoring: point scores + grouped bootstrap for every pair ──
    t0 = time.perf_counter()
    pair_list = [(r, s) for r in regions for s in subjects]
    n_test = len(shared_test_ids)
    boot_idx = (bootstrap_indices(n_test, n_bootstrap, seed=42) if bootstrap
                else np.zeros((0, int(n_test * 0.9)), np.int32))
    neural_mats = {(r, s): _neural_tensor(neural[r][s]["test"], shared_test_ids)
                   for r, s in pair_list}
    boot_by_pair, point_of_pair = grouped_scoring(
        model_rdms, neural_mats, {(r, s): best[r][s] for r, s in pair_list}, boot_idx)
    del neural_mats

    all_results = []
    last_region = None
    for region, subj in pair_list:
        if region != last_region:
            rprint(f"\n  -- Region: {region} --", style="info")
            last_region = region
        layer = best[region][subj]
        point = point_of_pair[(region, subj)]
        result = {
            "layer": layer,
            "compare_method": method,
            "score": point,
            "ci_low": None,
            "ci_high": None,
            "analysis": "rsa",
            "layer_selection_scores": sel_scores[region][subj],
        }
        msg = f"    {region} subj {subj} | {method.capitalize():<10}| {layer} = {point:.4f}"
        if bootstrap:
            boot = boot_by_pair[(region, subj)]
            result["ci_low"], result["ci_high"] = percentile_ci(boot)
            result["bootstrap_scores"] = boot.tolist()
            msg += f"  [95% CI: {result['ci_low']:.4f}, {result['ci_high']:.4f}]"
        rprint(msg, style="highlight")
        if cfg.get("log_expdata"):
            save_results([result], cfg.merge({"subject_idx": subj, "region": region}))
        all_results.append(result)
    LAST_PHASE_TIMES["scoring_bootstrap_s"] = time.perf_counter() - t0
    return all_results
