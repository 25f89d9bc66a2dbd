"""The evals (port of ``visreps_tpu/evals.py``) of a torchvision-
architecture model (AlexNet, VGG16, ResNet18/50, ViT-B/16, ECTiedNet;
untrained, or with local IMAGENET1K weights: cfg_id "pretrained") or of
a checkpoint (either package's, or the reference's torch-zip file), for
the four datasets the paper scores against.

NSD and TVSD share one multi-subject path. Every tap is extracted once
into the SRP store, then either the encoding score (``analysis=
encoding_score``: ridge regressions on every train row, batched per
subject across regions and layers, refits grouped across subjects;
``analysis/encoding.py``, ``ops/ridge.py``) or the two-phase RSA:

  * phase 1 — per (region, subject), pick the layer whose SRP-activation
    RDM best matches the neural RDM on a seed-42 subsample of
    ``n_select`` train stimuli;
  * phase 2 — exact (full-resolution) taps of the selected layers on the
    shared test stimuli, one RDM per unique layer;
  * scoring — average-tie Spearman point score of model vs neural RDM
    per pair, plus 1000 × 90 % subsample bootstrap CIs (grouped over
    pairs), saved to results.db.

THINGS (``things-behavior``) averages the store per concept, splits the
concepts 20/80 (RandomState(42)) into selection and evaluation, selects
a layer on the first, and scores the selected layer's concept means at
full resolution against the 66-d behavioural embeddings
(``analysis/rsa.compute_rsa``). NSD-Synthetic (``nsd_synthetic``) takes
each pair's layer from the NSD RSA row in results.db and scores its
exact taps on the 220 synthetic stimuli.

Every RDM goes through ``ops.rdm.compute_rdm`` — the Hopper kernel on
the card. Configurations outside the port raise NotImplementedError
naming the ROADMAP.md item that ports them.
"""
from __future__ import annotations

import json
import sqlite3
import time
from contextlib import closing
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from visreps_tpu_torch.analysis import encoding, rsa
from visreps_tpu_torch.analysis.alignment import (
    AlignmentData,
    align_stimulus_level,
    compute_traintest_alignment,
    prepare_concept_alignment,
    prepare_traintest_alignment,
    take_rows,
)
from visreps_tpu_torch.analysis.rsa import (
    concept_average_exact,
    select_best_layer,
    select_scores_multipair,
)
from visreps_tpu_torch.core import db
from visreps_tpu_torch.core.config import Config, get_seed_letter
from visreps_tpu_torch.core.db import compute_run_id, save_results
from visreps_tpu_torch.core.logging import Timer, rprint
from visreps_tpu_torch.data.loader import make_stimuli_loader
from visreps_tpu_torch.data.neural import (
    get_neural_loader,
    load_all_nsd_data,
    load_all_tvsd_data,
    load_nsd_synthetic_test_data,
)
from visreps_tpu_torch.data.transforms import get_transform
from visreps_tpu_torch.device import resolve_device
from visreps_tpu_torch.models.extractor import configure_feature_extractor
from visreps_tpu_torch.models.zoo import TORCHVISION_RETURN_NODES, checkpoint_path, load_model
from visreps_tpu_torch.ops.bootstrap import bootstrap_indices, grouped_scoring, percentile_ci
from visreps_tpu_torch.ops.rdm import compute_rdm, compute_rdm_correlation_batched

#: Wall-clock seconds of the last eval's phases: model_load_s,
#: data_load_s, extraction_s (of which extraction_loader_s waited on the
#: host loader), then for RSA phase1_selection_s, phase2_extract_s,
#: scoring_bootstrap_s, and for encoding encoding_s (the whole analysis)
#: with the encoding module's phases as encoding_{selection,refit,
#: assemble_bootstrap}_s on the subject-batched path. THINGS has
#: concept_avg_s and scoring_s, with compute_rsa's steps as scoring_*
#: (rsa.LAST_RSA_TIMES); NSD-Synthetic has data_load_s, model_load_s,
#: phase2_extract_s and scoring_bootstrap_s. Phases end with a device
#: synchronise. Rewritten by every eval() call.
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


def _sync(device: torch.device) -> None:
    """Wait for the card, so that a phase's time includes its launches."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _build_header(cfg) -> str:
    analysis = cfg.get("analysis", "rsa").upper()
    seed = cfg.get("seed", "?")
    seed_letter = get_seed_letter(seed) if isinstance(seed, int) else "?"
    parts = [f"{analysis} eval",
             f"cfg{cfg.get('cfg_id', '?')}{seed_letter} epoch {cfg.get('epoch', '?')}"]
    dataset = cfg.get("neural_dataset", "?").upper()
    region = cfg.get("region", "")
    parts.append(f"{dataset} {region}" if region and str(region).upper() != "N/A" else dataset)
    subj = cfg.get("subject_idx", "")
    if subj != "" and str(subj).upper() != "N/A":
        parts.append(f"subj {subj}")
    parts.append(f"seed {seed}")
    return " | ".join(parts)


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
    if dataset not in ("nsd", "tvsd", "things-behavior", "nsd_synthetic"):
        raise ValueError(f"Unsupported neural_dataset={dataset!r}")
    analysis = cfg.get("analysis", "rsa").lower()
    if analysis not in ("rsa", "encoding_score"):
        raise ValueError(f"Unknown analysis method: {analysis}")
    if analysis == "encoding_score" and dataset in ("things-behavior", "nsd_synthetic"):
        raise ValueError(f"analysis=encoding_score is not supported for {dataset}. "
                         "Use analysis=rsa instead.")
    if cfg.get("reconstruct_from_pcs"):
        missing("reconstruct_from_pcs", "Analysis remainder")
    if analysis == "rsa":
        method = cfg.get("compare_method", "spearman").lower()
        if method != "spearman":
            missing(f"compare_method={method} scoring", "Pearson/Kendall scoring")
        if cfg.get("bootstrap_exact_ties", "auto") is False:
            missing("bootstrap_exact_ties=false (dense-rank bootstrap)", "Pearson/Kendall scoring")
    if (cfg.get("load_model_from") != "checkpoint"
            and cfg.get("model_name", "AlexNet") not in TORCHVISION_RETURN_NODES):
        missing(f"model_name={cfg.get('model_name')}", "Remaining models")


def _store_kind(cfg, device: torch.device) -> str:
    """Where the SRP store lives: ``acts_store``, by default the card
    ("device", bf16) when there is one, else the host (f32)."""
    store = cfg.get("acts_store", "auto")
    if store == "auto":
        store = "device" if device.type == "cuda" else "host"
    return store


def eval(cfg: Config, device: str | torch.device | None = None) -> List[Dict]:
    """Run the eval ``cfg`` asks for (``neural_dataset`` nsd, tvsd,
    things-behavior or nsd_synthetic; ``analysis`` rsa, or
    encoding_score on nsd and tvsd); returns one result dict per
    (region, subject), one for THINGS.

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
    dataset = cfg.get("neural_dataset", "nsd").lower()
    if dataset == "things-behavior":
        return _eval_things(cfg, verbose, device)
    subjects = _listify(cfg.subject_idx)
    regions = _listify(cfg.region)
    if dataset == "nsd_synthetic":
        return _eval_rsa_nsd_synthetic(cfg, subjects, regions, verbose, device)

    # ── NSD / TVSD: the unified multi-subject path ──
    seed_letter = get_seed_letter(cfg.seed) if isinstance(cfg.seed, int) else "?"
    analysis = cfg.get("analysis", "rsa").lower()
    rprint(f"\n  {analysis.upper()} eval | cfg{cfg.cfg_id}{seed_letter} epoch {cfg.epoch} | "
           f"{dataset.upper()} | {len(subjects)} subjects x {len(regions)} regions | "
           f"seed {cfg.seed} | {device}\n", style="info")

    timer = Timer()
    model = load_model(cfg, device=device)
    extractor = configure_feature_extractor(cfg, model, device=device, verbose=verbose)
    LAST_PHASE_TIMES["model_load_s"] = timer.mark("model_load")

    load_all = load_all_nsd_data if dataset == "nsd" else load_all_tvsd_data
    all_data = load_all(cfg, subjects=subjects, regions=regions)
    LAST_PHASE_TIMES["data_load_s"] = timer.mark("data_load")
    stimuli = all_data["stimuli"]
    rprint(f"  {len(subjects)} subjects x {len(regions)} regions, {len(stimuli)} stimuli, "
           f"{len(all_data['shared_test_ids'])} shared test IDs", style="success")

    transform = get_transform("imgnet", normalize=not cfg.get("uint8_transfer", False))
    dl = make_stimuli_loader(stimuli, transform, cfg.batchsize, cfg.get("num_workers", 16))
    acts, ids = extractor.get_activations(dl, store=_store_kind(cfg, device))
    extractor.free_projection_cache()
    LAST_PHASE_TIMES["extraction_s"] = timer.mark("extraction")
    LAST_PHASE_TIMES["extraction_loader_s"] = extractor.last_extract_times["loader_s"]
    rprint("  Activations extracted once for all subjects/regions", style="success")
    if analysis == "encoding_score":
        return _eval_encoding(cfg, acts, ids, all_data, subjects, regions, verbose, device)
    return _eval_rsa(cfg, extractor, acts, ids, all_data, subjects, regions, verbose)


def _eval_things(cfg, verbose, device) -> List[Dict]:
    """Concept-level RSA against the THINGS behavioural embeddings: one
    result (region and subject "N/A")."""
    timer = Timer()
    rprint(f"\n  {_build_header(cfg)} | {device}\n", style="info")
    model = load_model(cfg, device=device)
    extractor = configure_feature_extractor(cfg, model, device=device, verbose=verbose)
    LAST_PHASE_TIMES["model_load_s"] = timer.mark("model_load")

    neural_data, dl = get_neural_loader(cfg)
    rprint("  THINGS data loaded", style="success")
    LAST_PHASE_TIMES["data_load_s"] = timer.mark("data_load")

    store = _store_kind(cfg, device)
    acts, ids = extractor.get_activations(dl, store=store)
    extractor.free_projection_cache()
    LAST_PHASE_TIMES["extraction_s"] = timer.mark("extraction")
    LAST_PHASE_TIMES["extraction_loader_s"] = extractor.last_extract_times["loader_s"]
    all_concepts = prepare_concept_alignment(cfg, acts, neural_data, ids)
    del acts, neural_data
    _sync(device)
    LAST_PHASE_TIMES["concept_avg_s"] = timer.mark("concept_avg")

    n_concepts = all_concepts.neural.shape[0]
    perm = np.random.RandomState(42).permutation(n_concepts)
    n_sel = int(n_concepts * 0.2)
    sel_idx, eval_idx = perm[:n_sel], perm[n_sel:]

    def split(idx) -> AlignmentData:
        return AlignmentData(
            activations={l: take_rows(a, idx) for l, a in all_concepts.activations.items()},
            neural=all_concepts.neural[idx],
            stimulus_ids=[all_concepts.stimulus_ids[i] for i in idx])

    selection, evaluation = split(sel_idx), split(eval_idx)
    evaluation.concept_image_ids = {c: all_concepts.concept_image_ids[c]
                                    for c in evaluation.stimulus_ids}
    del all_concepts
    rprint(f"  {n_sel} selection concepts, {len(eval_idx)} evaluation concepts", style="success")

    def re_extract(layer, ids=None):
        """The selected layer's full-resolution evaluation-concept means:
        averaged on the card during the forward for a device store, else
        averaged on the host."""
        if store == "device":
            return extractor.extract_single_layer_mean(
                dl, layer, evaluation.concept_image_ids, evaluation.stimulus_ids)
        raw, raw_ids = extractor.extract_single_layer(dl, layer)
        return concept_average_exact(raw, raw_ids, evaluation), evaluation.stimulus_ids

    scores = compute_traintest_alignment(cfg, selection, evaluation, verbose=verbose,
                                         re_extract_fn=re_extract, device=device)
    _sync(device)
    LAST_PHASE_TIMES["scoring_s"] = timer.mark("scoring")
    LAST_PHASE_TIMES.update({f"scoring_{k}": v for k, v in rsa.LAST_RSA_TIMES.items()})
    if cfg.get("log_expdata"):
        save_results(scores, cfg)
    return scores


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
    _sync(device)  # bill the queued RDM launches to phase 2
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
    all_results = _report(cfg, pair_list, best, point_of_pair,
                          boot_by_pair if bootstrap else None, sel_scores)
    LAST_PHASE_TIMES["scoring_bootstrap_s"] = time.perf_counter() - t0
    return all_results


def _report(cfg, pair_list, layer_of, point_of, boot_of, sel_scores) -> List[Dict]:
    """One result per (region, subject) pair, in ``pair_list`` order:
    printed and, with ``log_expdata``, saved to results.db. ``boot_of``
    {pair: bootstrap scores} is None without a bootstrap; ``sel_scores``
    {region: {subject: selection scores}} is None where the layers were
    not selected here (their entry is then [])."""
    method = cfg.get("compare_method", "spearman").lower()
    all_results = []
    last_region = None
    for region, subj in pair_list:
        if region != last_region:
            rprint(f"\n  -- Region: {region} --", style="info")
            last_region = region
        layer = layer_of[region][subj]
        point = point_of[(region, subj)]
        result = {
            "layer": layer,
            "compare_method": method,
            "score": point,
            "ci_low": None,
            "ci_high": None,
            "analysis": "rsa",
            "layer_selection_scores": [] if sel_scores is None else sel_scores[region][subj],
        }
        msg = f"    {region} subj {subj} | {method.capitalize():<10}| {layer} = {point:.4f}"
        if boot_of is not None:
            boot = boot_of[(region, subj)]
            result["ci_low"], result["ci_high"] = percentile_ci(boot)
            result["bootstrap_scores"] = boot.tolist()
            msg += f"  [95% CI: {result['ci_low']:.4f}, {result['ci_high']:.4f}]"
        rprint(msg, style="highlight")
        if cfg.get("log_expdata"):
            save_results([result], cfg.merge({"subject_idx": subj, "region": region}))
        all_results.append(result)
    return all_results


def _lookup_nsd_best_layers(cfg, subjects, regions) -> Dict:
    """{region: {subject: layer}} from results.db: each pair's NSD RSA
    row, found by the run_id the NSD eval of this configuration wrote
    (``compute_run_id`` with neural_dataset nsd and analysis rsa), so a
    row written by either package is found. Raises ValueError naming the
    pair when there is none."""
    method = cfg.get("compare_method", "spearman").lower()
    layers: Dict = {}
    with closing(sqlite3.connect(str(db.RESULTS_DB_PATH))) as conn:
        for region in regions:
            layers[region] = {}
            for subj in subjects:
                run_id = compute_run_id(cfg.merge({
                    "neural_dataset": "nsd", "analysis": "rsa", "subject_idx": subj,
                    "region": region, "compare_method": method}))
                try:
                    row = conn.execute("SELECT layer FROM results WHERE run_id=? AND "
                                       "compare_method=?", (run_id, method)).fetchone()
                except sqlite3.OperationalError:  # a new, empty database
                    row = None
                if row is None:
                    raise ValueError(
                        f"No NSD RSA result found (run_id={run_id}) for seed={cfg.seed}, "
                        f"region={region}, subj={subj}, cfg_id={cfg.get('cfg_id')}. "
                        "Run NSD eval first.")
                layers[region][subj] = row[0]
    return layers


def _eval_rsa_nsd_synthetic(cfg, subjects, regions, verbose, device) -> List[Dict]:
    """RSA on the NSD-Synthetic stimuli with each pair's layer inherited
    from its NSD eval: exact taps of the unique layers (one pass,
    normalised on the host), one RDM each, then grouped scoring (neural
    RDMs, average-tie point scores, bootstrap) with a bootstrap, or the
    batched average-tie point scores without one."""
    method = cfg.get("compare_method", "spearman").lower()
    bootstrap = cfg.get("bootstrap", False)
    seed_letter = get_seed_letter(cfg.seed) if isinstance(cfg.seed, int) else "?"
    rprint(f"\n  RSA eval (NSD Synthetic) | cfg{cfg.get('cfg_id', '?')}{seed_letter} "
           f"epoch {cfg.get('epoch', '?')} | {len(subjects)} subjects x {len(regions)} regions | "
           f"seed {cfg.seed} | {device}\n", style="info")
    timer = Timer()
    best = _lookup_nsd_best_layers(cfg, subjects, regions)
    test_data = load_nsd_synthetic_test_data(cfg, subjects=subjects, regions=regions)
    test_ids = test_data["test_ids"]
    rprint(f"  Loaded {len(test_ids)} synthetic test stimuli", style="success")
    LAST_PHASE_TIMES["data_load_s"] = timer.mark("data_load")

    model = load_model(cfg, device=device)
    extractor = configure_feature_extractor(cfg, model, device=device, verbose=verbose)
    LAST_PHASE_TIMES["model_load_s"] = timer.mark("model_load")

    unique_layers = sorted({l for rl in best.values() for l in rl.values()})
    rprint(f"  Extracting {len(unique_layers)} unique layers (one pass)...", style="info")
    dl_test = make_stimuli_loader(test_data["stimuli"], get_transform("imgnet"), cfg.batchsize,
                                  cfg.get("num_workers", 16))
    exact, _ = extractor.extract_layers_exact(dl_test, unique_layers, test_ids)
    model_rdms = {layer: compute_rdm(exact.pop(layer)) for layer in unique_layers}
    _sync(device)
    LAST_PHASE_TIMES["phase2_extract_s"] = timer.mark("phase2_extract")

    pair_list = [(r, s) for r in regions for s in subjects]
    neural_mats = {(r, s): _neural_tensor(test_data["neural"][r][s], test_ids)
                   for r, s in pair_list}
    boot_by_pair = None
    if bootstrap:
        boot_by_pair, point_of_pair = grouped_scoring(
            model_rdms, neural_mats, {(r, s): best[r][s] for r, s in pair_list},
            bootstrap_indices(len(test_ids), cfg.get("n_bootstrap", 1000), seed=42))
    else:
        neural_rdms = torch.stack([compute_rdm(torch.as_tensor(neural_mats[k], device=device))
                                   for k in pair_list])
        model_stack = torch.stack([model_rdms[best[r][s]] for r, s in pair_list])
        points = compute_rdm_correlation_batched(model_stack, neural_rdms, method).tolist()
        point_of_pair = dict(zip(pair_list, points))
    del neural_mats
    all_results = _report(cfg, pair_list, best, point_of_pair, boot_by_pair, None)
    LAST_PHASE_TIMES["scoring_bootstrap_s"] = timer.mark("scoring")
    return all_results


def _eval_encoding(cfg, acts, ids, all_data, subjects, regions, verbose, device) -> List[Dict]:
    """Encoding score over every train row of the SRP store ``acts``.

    Batched per SUBJECT across regions and layers
    (``encoding.compute_encoding_scores_subjects``: one concatenated Y per
    subject, stacked layer selection, refits grouped across subjects);
    the per-pair path runs when the regions' stimulus sets differ or
    ``encoding_batched=false``. Results are in subject-major order on the
    batched path and region-major on the per-pair one, as in the JAX
    package, with one results.db row per (region, subject).
    """
    t0 = time.perf_counter()
    neural = all_data["neural"]
    all_results = []
    bootstrap = cfg.get("bootstrap", True)
    n_bootstrap = cfg.get("n_bootstrap", 1000)

    def save(scores, region, subj):
        if cfg.get("log_expdata"):
            save_results(scores, cfg.merge({"subject_idx": subj, "region": region}))
        all_results.extend(scores)

    batched = cfg.get("encoding_batched", True) and all(
        frozenset(neural[r][subj][split]) == frozenset(neural[regions[0]][subj][split])
        for subj in subjects for split in ("train", "test") for r in regions)
    if batched:
        subject_inputs = {}
        for subj in subjects:
            first = neural[regions[0]][subj]
            train_acts, _, train_ids = align_stimulus_level(acts, first["train"], ids)
            test_acts, _, test_ids = align_stimulus_level(acts, first["test"], ids)
            y_train = {r: _neural_tensor(neural[r][subj]["train"], train_ids) for r in regions}
            y_test = {r: _neural_tensor(neural[r][subj]["test"], test_ids) for r in regions}
            subject_inputs[subj] = (train_acts, test_acts, y_train, y_test)
        per_subject = encoding.compute_encoding_scores_subjects(
            subject_inputs, bootstrap=bootstrap, n_bootstrap=n_bootstrap, verbose=verbose,
            cv_precision=cfg.get("encoding_cv_precision", "high"), device=device)
        LAST_PHASE_TIMES.update({f"encoding_{k}": v for k, v in encoding.LAST_PHASE_TIMES.items()})
        for subj in subjects:
            for region in regions:
                save(per_subject[subj][region], region, subj)
    else:
        for region in regions:
            rprint(f"\n  -- Region: {region} --", style="info")
            for subj in subjects:
                train_data, test_data = prepare_traintest_alignment(
                    cfg, acts, neural[region][subj], ids)
                scores = compute_traintest_alignment(cfg, train_data, test_data,
                                                     verbose=verbose, device=device)
                del train_data, test_data
                save(scores, region, subj)
    LAST_PHASE_TIMES["encoding_s"] = time.perf_counter() - t0
    return all_results
