"""The evals (port of ``visreps_tpu/evals.py``) of a torchvision-
architecture model (AlexNet, VGG16, ResNet18/50, ViT-B/16, ECTiedNet;
untrained, or with local IMAGENET1K weights: cfg_id "pretrained") or of
a checkpoint (either package's, or the reference's torch-zip file), for
the four datasets the paper scores against.

NSD and TVSD share one multi-subject path. Every tap is extracted once
into the SRP store (for RSA only phase 1's rows where the JAX package's
rule retains, ``store_plan``), then either the encoding score (``analysis=
encoding_score``: ridge regressions on every train row, batched per
subject across regions and layers, refits grouped across subjects;
``analysis/encoding.py``, ``ops/ridge.py``) or the two-phase RSA:

  * phase 1 — per (region, subject), pick the layer whose SRP-activation
    RDM best matches the neural RDM on a seed-42 subsample of
    ``n_select`` train stimuli;
  * phase 2 — exact (full-resolution) taps of the selected layers on the
    shared test stimuli, in as many passes as the card's memory needs
    (with ``reconstruct_from_pcs``, rebuilt from their top ``pca_k``
    PCs), one RDM per unique layer;
  * scoring — per pair the point score of model vs neural RDM plus
    1000 × 90 % subsample bootstrap CIs, saved to results.db. Spearman
    is grouped over the pairs and average-tie exact; Kendall, Pearson
    and the dense-rank Spearman bootstrap (``bootstrap_exact_ties=
    false``) score pair by pair (``_score_pairs``).

THINGS (``things-behavior``) averages the store per concept, splits the
concepts 20/80 (RandomState(42)) into selection and evaluation, selects
a layer on the first, and scores the selected layer's concept means at
full resolution against the 66-d behavioural embeddings
(``analysis/rsa.compute_rsa``). NSD-Synthetic (``nsd_synthetic``) takes
each pair's layer from the NSD RSA row in results.db and scores its
exact taps on the 220 synthetic stimuli.

Every RDM goes through ``ops.rdm.compute_rdm`` — the Hopper kernel on
the card — except, under a multi-rank mesh, those of at least
``rdm_shard_threshold`` (4096) stimuli, which take the row-block ring
``parallel.rdm_sharded`` (``_rdm``). Under a mesh (``torchrun``, one
process per GPU; ``parallel.default_mesh``) extraction batches split over
the 'data' axis and the bootstrap iterations too; every rank computes the
single-process results and only rank 0 writes results.db. Models outside
the port raise NotImplementedError naming the ROADMAP.md item that ports
them.
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
from visreps_tpu_torch.ops.bootstrap import (
    bootstrap_indices,
    bootstrap_rdm_correlation,
    grouped_scoring,
    percentile_ci,
)
from visreps_tpu_torch.ops.pca import reconstruct_from_pcs
from visreps_tpu_torch.ops.rdm import compute_rdm, compute_rdm_correlation_batched
from visreps_tpu_torch.parallel.auto import default_mesh
from visreps_tpu_torch.parallel.mesh import is_writer, world_size
from visreps_tpu_torch.parallel.shard import mesh_batch_size, rdm_sharded

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


def _rdm(x, mesh, cfg) -> torch.Tensor:
    """``compute_rdm``, or under a mesh the row-block ring
    ``rdm_sharded`` when the matrix has at least ``rdm_shard_threshold``
    rows (4096), enough to amortise the all-gather."""
    if mesh is not None and x.shape[0] >= cfg.get("rdm_shard_threshold", 4096):
        return rdm_sharded(x, mesh)
    return compute_rdm(x)


def _save(rows, cfg) -> None:
    """Write ``rows`` to results.db under ``log_expdata``, from rank 0
    only (every rank of a mesh holds the same rows)."""
    if cfg.get("log_expdata") and is_writer():
        save_results(rows, cfg)


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
    """Raise for configurations the evals refuse, and for models this port
    does not cover yet."""
    dataset = cfg.get("neural_dataset", "nsd").lower()
    if dataset not in ("nsd", "tvsd", "things-behavior", "nsd_synthetic"):
        raise ValueError(f"Unsupported neural_dataset={dataset!r}")
    analysis = cfg.get("analysis", "rsa").lower()
    if analysis not in ("rsa", "encoding_score"):
        raise ValueError(f"Unknown analysis method: {analysis}")
    if analysis == "encoding_score" and dataset in ("things-behavior", "nsd_synthetic"):
        raise ValueError(f"analysis=encoding_score is not supported for {dataset}. "
                         "Use analysis=rsa instead.")
    if (cfg.get("load_model_from") != "checkpoint"
            and cfg.get("model_name", "AlexNet") not in TORCHVISION_RETURN_NODES):
        raise NotImplementedError(f"model_name={cfg.get('model_name')} is not ported yet "
                                  "(ROADMAP.md, 'Remaining models')")


#: Bytes of bf16 SRP store above which ``acts_retain=auto`` retains and
#: ``acts_store=auto`` takes the host (the JAX package's 9e9).
STORE_BUDGET_BYTES = 9e9


def store_plan(cfg, device_type: str, n_stimuli: int, out_dims_total: int,
               retain_union: set | None = None) -> tuple[set | None, str]:
    """The JAX package's retention and store rule
    (``visreps_tpu/evals.py:238-262``, THINGS ``:318-331``): returns
    (the stimulus ids to keep, or None for every row; "device" or "host").

    ``retain_union`` is the RSA phase-1 plan's union (None for encoding
    and THINGS, which never retain). ``acts_retain``: "auto" retains only
    on the card when the whole bf16 store, 2 · n_stimuli ·
    ``out_dims_total`` bytes, reaches the budget; a true value always
    retains, a false one never; a retain set as large as the stimulus set
    is no retention. Under several ranks nothing is retained, as in the
    JAX package under several processes (``extractor.py:456``).
    ``acts_store``: "auto" takes the bf16 device store on the card when
    the kept rows' store is positive and under the budget, else the f32
    host store.
    """
    retain = None
    if retain_union is not None and world_size() == 1:
        mode = cfg.get("acts_retain", "auto")
        if mode == "auto":
            if device_type == "cuda" and 2 * n_stimuli * out_dims_total >= STORE_BUDGET_BYTES:
                retain = retain_union
        elif mode:
            retain = retain_union
        if retain is not None and len(retain) >= n_stimuli:
            retain = None
    store = cfg.get("acts_store", "auto")
    if store == "auto":
        n_store = len(retain) if retain is not None else n_stimuli
        est = 2 * n_store * out_dims_total
        store = "device" if device_type == "cuda" and 0 < est < STORE_BUDGET_BYTES else "host"
    return retain, store


def eval(cfg: Config, device: str | torch.device | None = None, mesh=None) -> List[Dict]:
    """Run the eval ``cfg`` asks for (``neural_dataset`` nsd, tvsd,
    things-behavior or nsd_synthetic; ``analysis`` rsa, or
    encoding_score on nsd and tvsd); returns one result dict per
    (region, subject), one for THINGS.

    ``device`` defaults to CUDA (raising when there is none); pass
    ``"cpu"`` to run on the CPU with the kernel's plain version. ``mesh``
    defaults to ``default_mesh(cfg)``: None in one process.
    """
    device = resolve_device(device)
    if mesh is None:
        mesh = default_mesh(cfg)
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
        return _eval_things(cfg, verbose, device, mesh)
    subjects = _listify(cfg.subject_idx)
    regions = _listify(cfg.region)
    if dataset == "nsd_synthetic":
        return _eval_rsa_nsd_synthetic(cfg, subjects, regions, verbose, device, mesh)

    # ── NSD / TVSD: the unified multi-subject path ──
    seed_letter = get_seed_letter(cfg.seed) if isinstance(cfg.seed, int) else "?"
    analysis = cfg.get("analysis", "rsa").lower()
    rprint(f"\n  {analysis.upper()} eval | cfg{cfg.cfg_id}{seed_letter} epoch {cfg.epoch} | "
           f"{dataset.upper()} | {len(subjects)} subjects x {len(regions)} regions | "
           f"seed {cfg.seed} | {device}\n", style="info")

    timer = Timer()
    model = load_model(cfg, device=device)
    extractor = configure_feature_extractor(cfg, model, device=device, verbose=verbose)
    extractor.mesh = mesh
    LAST_PHASE_TIMES["model_load_s"] = timer.mark("model_load")

    load_all = load_all_nsd_data if dataset == "nsd" else load_all_tvsd_data
    all_data = load_all(cfg, subjects=subjects, regions=regions)
    LAST_PHASE_TIMES["data_load_s"] = timer.mark("data_load")
    stimuli = all_data["stimuli"]
    rprint(f"  {len(subjects)} subjects x {len(regions)} regions, {len(stimuli)} stimuli, "
           f"{len(all_data['shared_test_ids'])} shared test IDs", style="success")

    transform = get_transform("imgnet", normalize=not cfg.get("uint8_transfer", False))
    dl = make_stimuli_loader(stimuli, transform, mesh_batch_size(cfg.batchsize, mesh),
                             cfg.get("num_workers", 16))
    # RSA's phase 1 reads only the plan's rows, so the plan comes first and
    # extraction may keep just those; encoding needs every train row.
    plan = union = None
    if analysis == "rsa":
        plan = _selection_plan(all_data["neural"], subjects, regions, stimuli,
                               cfg.get("n_select", 1000))
        union = set().union(*plan.values())
    retain, store = store_plan(cfg, device.type, len(stimuli),
                               sum(extractor.out_dims().values()), union)
    acts, ids = extractor.get_activations(dl, store=store, retain_ids=retain)
    extractor.free_projection_cache()
    LAST_PHASE_TIMES["extraction_s"] = timer.mark("extraction")
    LAST_PHASE_TIMES["extraction_loader_s"] = extractor.last_extract_times["loader_s"]
    rprint("  Activations extracted once for all subjects/regions", style="success")
    if analysis == "encoding_score":
        return _eval_encoding(cfg, acts, ids, all_data, subjects, regions, verbose, device)
    # Boxed, with this frame's name dropped, so that _eval_rsa's release
    # after phase 1 frees the store before phase 2's exact taps.
    acts_box = [acts]
    del acts
    return _eval_rsa(cfg, extractor, acts_box, ids, all_data, subjects, regions, verbose, plan,
                     mesh)


def _eval_things(cfg, verbose, device, mesh=None) -> List[Dict]:
    """Concept-level RSA against the THINGS behavioural embeddings: one
    result (region and subject "N/A")."""
    timer = Timer()
    rprint(f"\n  {_build_header(cfg)} | {device}\n", style="info")
    model = load_model(cfg, device=device)
    extractor = configure_feature_extractor(cfg, model, device=device, verbose=verbose)
    extractor.mesh = mesh
    LAST_PHASE_TIMES["model_load_s"] = timer.mark("model_load")

    neural_data, dl = get_neural_loader(cfg if mesh is None else cfg.merge(
        {"batchsize": mesh_batch_size(cfg.batchsize, mesh)}))
    rprint("  THINGS data loaded", style="success")
    LAST_PHASE_TIMES["data_load_s"] = timer.mark("data_load")

    _, store = store_plan(cfg, device.type, len(dl.dataset), sum(extractor.out_dims().values()))
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

    # PC reconstruction needs the per-image matrix, so it averages on the host.
    pca_k = cfg.get("pca_k", 1) if cfg.get("reconstruct_from_pcs") else None
    device_avg = store == "device" and pca_k is None

    def re_extract(layer, ids=None):
        """The selected layer's full-resolution evaluation-concept means:
        averaged on the card during the forward for a device store, else
        (and always with ``reconstruct_from_pcs``: the per-image rows are
        rebuilt from their top ``pca_k`` PCs on the card first) averaged
        on the host."""
        if device_avg:
            return extractor.extract_single_layer_mean(
                dl, layer, evaluation.concept_image_ids, evaluation.stimulus_ids)
        raw, raw_ids = extractor.extract_single_layer(dl, layer)
        if pca_k is not None:
            raw = reconstruct_from_pcs({layer: raw}, pca_k, device=device)[layer]
            rprint(f"    Reconstructed from {pca_k} PCs", style="info")
        return concept_average_exact(raw, raw_ids, evaluation), evaluation.stimulus_ids

    scores = compute_traintest_alignment(cfg, selection, evaluation, verbose=verbose,
                                         re_extract_fn=re_extract, device=device, mesh=mesh)
    _sync(device)
    LAST_PHASE_TIMES["scoring_s"] = timer.mark("scoring")
    LAST_PHASE_TIMES.update({f"scoring_{k}": v for k, v in rsa.LAST_RSA_TIMES.items()})
    _save(scores, cfg)
    return scores


def _model_rdms(cfg, exact: dict, layers, mesh=None) -> dict:
    """One RDM per layer of the exact taps ``exact`` (popped as they are
    used; ``_rdm`` routes them under a mesh); with ``reconstruct_from_pcs``
    each tap is first rebuilt from its top ``pca_k`` PCs."""
    pca_k = cfg.get("pca_k", 1)
    rdms = {}
    for layer in layers:
        acts = exact.pop(layer)
        if cfg.get("reconstruct_from_pcs"):
            acts = reconstruct_from_pcs({layer: acts}, pca_k)[layer]
            rprint(f"    Reconstructed {layer} from {pca_k} PCs", style="info")
        rdms[layer] = _rdm(acts, mesh, cfg)
    return rdms


def _exact_groups(extractor, layers, n_rows: int) -> list:
    """``layers`` in groups, in order, whose f32 exact taps over ``n_rows``
    stimuli fit half the card's free memory (the other half is for the
    forward, the row gather and an RDM's centred copy); one group on the
    CPU. VGG16's conv1-2 taps at 1,000 stimuli are 12.8 GB each, so the
    13 layers a 16-pair eval can select do not fit one pass."""
    if extractor.device.type != "cuda":
        return [list(layers)]
    dev = extractor.device
    free = (torch.cuda.mem_get_info(dev)[0] + torch.cuda.memory_reserved(dev)
            - torch.cuda.memory_allocated(dev))
    groups, size = [[]], 0
    for layer in layers:
        nbytes = 4 * n_rows * extractor.tap_dims[layer]
        if groups[-1] and size + nbytes > free / 2:
            groups.append([])
            size = 0
        groups[-1].append(layer)
        size += nbytes
    return groups


def _exact_rdms(cfg, extractor, loader, layers, stimulus_ids, mesh=None) -> dict:
    """One RDM per layer of ``layers``' exact taps over ``loader`` (rows in
    ``stimulus_ids`` order): one loader pass per ``_exact_groups`` group,
    each group's taps freed as its RDMs are built."""
    groups = _exact_groups(extractor, layers, len(loader.dataset))
    if len(groups) > 1:
        rprint(f"  {len(layers)} layers in {len(groups)} passes (device memory)", style="info")
    rdms = {}
    for group in groups:
        exact, _ = extractor.extract_layers_exact(loader, group, stimulus_ids)
        rdms.update(_model_rdms(cfg, exact, group, mesh))
    return rdms


def _score_pairs(cfg, model_rdms: dict, neural_mats: dict, pair_layer: dict, n_test: int,
                 mesh=None):
    """Point scores and bootstraps of every (region, subject) pair:
    ({pair: (B,) bootstrap scores} or None without a bootstrap, {pair:
    point score}). All pairs share RandomState(42)'s index sets.

    Spearman is grouped over the pairs (``grouped_scoring``: neural RDMs,
    average-tie point scores and bootstrap in one pass) unless a bootstrap
    asks for dense ranks (``bootstrap_exact_ties=false``). That, Kendall
    and Pearson take the per-pair route: the P neural RDMs, one batched
    point-score call, then ``bootstrap_rdm_correlation`` per pair (dense
    ranks for Spearman: under "auto" or true it never comes here, so the
    JAX package's tie detection on this route is not needed). Under a
    multi-rank ``mesh`` both routes shard the bootstrap iterations, and
    the per-pair route's neural RDMs go through ``_rdm``."""
    method = cfg.get("compare_method", "spearman").lower()
    bootstrap = cfg.get("bootstrap", False)
    boot_idx = (bootstrap_indices(n_test, cfg.get("n_bootstrap", 1000), seed=42) if bootstrap
                else np.zeros((0, int(n_test * 0.9)), np.int32))
    if method == "spearman" and not (bootstrap and cfg.get("bootstrap_exact_ties", "auto") is False):
        boot_of, point_of = grouped_scoring(model_rdms, neural_mats, pair_layer, boot_idx,
                                            mesh=mesh)
        return (boot_of if bootstrap else None), point_of
    pairs = list(neural_mats)
    device = next(iter(model_rdms.values())).device
    neural_rdms = {k: _rdm(torch.as_tensor(neural_mats[k], device=device), mesh, cfg)
                   for k in pairs}
    points = compute_rdm_correlation_batched(
        torch.stack([model_rdms[pair_layer[k]] for k in pairs]),
        torch.stack([neural_rdms[k] for k in pairs]), method).tolist()
    boot_of = None
    if bootstrap:
        boot_of = {k: bootstrap_rdm_correlation(model_rdms[pair_layer[k]], neural_rdms[k],
                                                method=method, indices=boot_idx, mesh=mesh)
                   for k in pairs}
    return boot_of, dict(zip(pairs, points))


def _eval_rsa(cfg, extractor, acts_box, ids, all_data, subjects, regions, verbose,
              plan, mesh=None) -> List[Dict]:
    """Two-phase RSA over the extracted SRP store, boxed in the
    one-element list ``acts_box`` (emptied here, so the store is freed
    after phase 1), whose rows ``ids`` hold at least ``plan``'s."""
    acts = acts_box.pop()
    method = cfg.get("compare_method", "spearman").lower()
    exact_sel = bool(cfg.get("selection_exact_ties", False))
    neural = all_data["neural"]
    shared_test_ids = all_data["shared_test_ids"]
    stimuli = all_data["stimuli"]
    device = extractor.device
    tap_names = list(acts)
    id_pos = {str(k): i for i, k in enumerate(ids)}
    missing = [k for sel in plan.values() for k in sel if k not in id_pos]
    if missing:
        raise RuntimeError(f"{len(missing)} planned selection stimuli missing from the "
                           f"extraction output (e.g. {missing[:3]})")

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
                                  mesh_batch_size(min(int(cfg.batchsize), 256), mesh),
                                  cfg.get("num_workers", 16))
    rprint(f"  Re-extracting {len(unique_layers)} unique layers over "
           f"{len(test_stimuli)} test stimuli...", style="info")
    model_rdms = _exact_rdms(cfg, extractor, dl_test, unique_layers, shared_test_ids, mesh)
    _sync(device)  # bill the queued RDM launches to phase 2
    LAST_PHASE_TIMES["phase2_extract_s"] = time.perf_counter() - t0

    # ── Scoring: point scores + bootstraps for every pair ──
    t0 = time.perf_counter()
    pair_list = [(r, s) for r in regions for s in subjects]
    neural_mats = {(r, s): _neural_tensor(neural[r][s]["test"], shared_test_ids)
                   for r, s in pair_list}
    boot_by_pair, point_of_pair = _score_pairs(
        cfg, model_rdms, neural_mats, {(r, s): best[r][s] for r, s in pair_list},
        len(shared_test_ids), mesh)
    del neural_mats
    all_results = _report(cfg, pair_list, best, point_of_pair, boot_by_pair, sel_scores)
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
        _save([result], cfg.merge({"subject_idx": subj, "region": region}))
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


def _eval_rsa_nsd_synthetic(cfg, subjects, regions, verbose, device, mesh=None) -> List[Dict]:
    """RSA on the NSD-Synthetic stimuli with each pair's layer inherited
    from its NSD eval: exact taps of the unique layers (one pass,
    normalised on the host; PC-reconstructed with ``reconstruct_from_pcs``),
    one RDM each, then ``_score_pairs`` as in the NSD eval."""
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
    extractor.mesh = mesh
    LAST_PHASE_TIMES["model_load_s"] = timer.mark("model_load")

    unique_layers = sorted({l for rl in best.values() for l in rl.values()})
    rprint(f"  Extracting {len(unique_layers)} unique layers...", style="info")
    dl_test = make_stimuli_loader(test_data["stimuli"], get_transform("imgnet"),
                                  mesh_batch_size(cfg.batchsize, mesh), cfg.get("num_workers", 16))
    model_rdms = _exact_rdms(cfg, extractor, dl_test, unique_layers, test_ids, mesh)
    _sync(device)
    LAST_PHASE_TIMES["phase2_extract_s"] = timer.mark("phase2_extract")

    pair_list = [(r, s) for r in regions for s in subjects]
    neural_mats = {(r, s): _neural_tensor(test_data["neural"][r][s], test_ids)
                   for r, s in pair_list}
    boot_by_pair, point_of_pair = _score_pairs(
        cfg, model_rdms, neural_mats, {(r, s): best[r][s] for r, s in pair_list}, len(test_ids),
        mesh)
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
        _save(scores, cfg.merge({"subject_idx": subj, "region": region}))
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
            reconstruct_pca_k=cfg.get("pca_k", 1) if cfg.get("reconstruct_from_pcs") else None,
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
