"""pca_k reconstruction sweep (port of
``experiments/reconstruction_analysis/run_reconstruction.py``): how much
brain alignment survives a top-k-PC reconstruction of the best layer's
activations.

Phase-1 selection is skipped: each (region, subject)'s best layer comes
from the 1000-way baseline rows in results.db. Each unique best layer is
re-extracted once at full resolution (one loader pass for all of them,
the taps kept on the device), and its PCs fitted once (``ops/pca.fit_pca``:
an f64 Gram eigh, the largest ``pca_k`` kept); then for each ``pca_k``
every layer is rebuilt from its top-k PCs (``reconstruct_from_pcs``'s
rebuild), its RDM built (``ops/rdm.compute_rdm``: the Hopper kernel on
the card, as is each neural RDM's), scored against the neural RDM with a
seed-42 bootstrap CI, and saved with ``reconstruct_from_pcs=1`` (INSERT
OR REPLACE). THINGS draws its 80 % evaluation concepts from
``RandomState(42).permutation`` and averages the reconstructed image
rows per concept on the host (``rsa.concept_average_exact``).

Usage:
  python -m visreps_tpu_torch.experiments.reconstruction_analysis.run_reconstruction \\
      --checkpoint-dir /path/ckpts --datasets nsd tvsd --seeds 1 2 3 [--device cpu]
"""
from __future__ import annotations

import argparse
import sqlite3

import numpy as np
import torch

from visreps_tpu_torch.core import db as core_db
from visreps_tpu_torch.core.config import Config
from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.device import resolve_device
from visreps_tpu_torch.ops.bootstrap import bootstrap_rdm_correlation, percentile_ci
from visreps_tpu_torch.ops.pca import fit_pca
from visreps_tpu_torch.ops.rdm import compute_rdm, compute_rdm_correlation

DATASET_CONFIG = {
    "nsd": {"regions": ["early visual stream", "ventral visual stream"],
            "subjects": list(range(8))},
    "tvsd": {"regions": ["V1", "V4", "IT"], "subjects": [0, 1]},
    "things-behavior": {"regions": ["N/A"], "subjects": ["N/A"]},
}


def query_best_layers(neural_dataset: str, seed: int, cfg_id, checkpoint_dir: str,
                      compare_method: str) -> dict:
    """{(region, subject_idx as str): best layer} from the baseline rows
    (``reconstruct_from_pcs = 0``); cfg_id and seed match as strings."""
    conn = sqlite3.connect(str(core_db.RESULTS_DB_PATH))
    rows = conn.execute(
        """SELECT region, subject_idx, layer, score FROM results
           WHERE cfg_id = ? AND checkpoint_dir = ? AND reconstruct_from_pcs = 0
             AND analysis = 'rsa' AND compare_method = ?
             AND neural_dataset = ? AND seed = ?""",
        (str(cfg_id), checkpoint_dir, compare_method, neural_dataset, str(seed)),
    ).fetchall()
    conn.close()
    if not rows:
        raise ValueError(
            f"No baseline results for {neural_dataset} seed={seed}. "
            "Run the standard 1000-way evaluation first."
        )
    best: dict = {}
    for region, subj, layer, score in rows:
        key = (region, str(subj))
        if key not in best or score > best[key][1]:
            best[key] = (layer, score)
    return {k: v[0] for k, v in best.items()}


def build_cfg(args, seed: int, neural_dataset: str) -> Config:
    """The sweep's eval config merged over the checkpoint's training config."""
    from visreps_tpu_torch.evals import _load_cfg

    cfg = Config({
        "mode": "eval", "neural_dataset": neural_dataset,
        "return_nodes": ["conv1", "conv2", "conv3", "conv4", "conv5", "fc1", "fc2"],
        "extract_pre_and_post": True, "reconstruct_from_pcs": True, "pca_k": 1,
        "load_model_from": "checkpoint", "seed": seed, "cfg_id": args.cfg_id,
        "checkpoint_dir": args.checkpoint_dir,
        "checkpoint_model": args.checkpoint_model,
        "analysis": "rsa", "compare_method": args.compare_method,
        "bootstrap": True, "n_bootstrap": args.n_bootstrap,
        "batchsize": args.batch_size, "num_workers": args.num_workers,
        "uint8_transfer": args.uint8_transfer, "log_expdata": True, "verbose": False,
    })
    return _load_cfg(cfg)


def score_with_ci(model_rdm, neural_rdm, method: str, n_bootstrap: int):
    """(point score, CI low, CI high, bootstrap list) of one RDM pair."""
    point = compute_rdm_correlation(model_rdm, neural_rdm, correlation=method)
    boot = bootstrap_rdm_correlation(model_rdm, neural_rdm,
                                     n_bootstrap=n_bootstrap, seed=42, method=method)
    lo, hi = percentile_ci(boot)
    return point, lo, hi, boot.tolist()


def fit_layer_pcs(acts: dict, k: int) -> dict:
    """{layer: its (n, features) rows' PCA, the top k components kept}."""
    return {l: fit_pca(torch.as_tensor(a).reshape(len(a), -1), k) for l, a in acts.items()}


def reconstruct_from_pcs(acts: dict, pcas: dict, k: int) -> dict:
    """Each layer's rows rebuilt from the first k components of its fit,
    as ``ops/pca.reconstruct_from_pcs`` rebuilds them: flattened, in the
    input's dtype."""
    out = {}
    for l, a in acts.items():
        flat = a.reshape(a.shape[0], -1)
        out[l] = pcas[l].top(k).reconstruct(flat.to(torch.float32)).to(a.dtype)
    return out


def _save(cfg, layer, score, lo, hi, boot):
    core_db.save_results([{
        "layer": layer, "compare_method": cfg.compare_method, "score": score,
        "ci_low": lo, "ci_high": hi, "analysis": "rsa",
        "layer_selection_scores": [], "bootstrap_scores": boot,
    }], cfg)


def _model(cfg, device):
    from visreps_tpu_torch.models.extractor import configure_feature_extractor
    from visreps_tpu_torch.models.zoo import load_model

    return configure_feature_extractor(cfg, load_model(cfg, device=device), device=device)


def run_nsd_tvsd(args, neural_dataset: str, device=None) -> None:
    """The sweep over NSD's or TVSD's (region, subject) pairs on the shared
    test stimuli."""
    from visreps_tpu_torch.data.loader import make_stimuli_loader
    from visreps_tpu_torch.data.neural import load_all_nsd_data, load_all_tvsd_data
    from visreps_tpu_torch.data.transforms import get_transform

    device = resolve_device(device)
    ds = DATASET_CONFIG[neural_dataset]
    regions, subjects = ds["regions"], ds["subjects"]
    for seed in args.seeds:
        rprint(f"\n  {neural_dataset.upper()} | seed {seed}", style="info")
        best_layers = query_best_layers(
            neural_dataset, seed, args.cfg_id, args.checkpoint_dir, args.compare_method
        )

        cfg = build_cfg(args, seed, neural_dataset)
        extractor = _model(cfg, device)

        loader_fn = load_all_nsd_data if neural_dataset == "nsd" else load_all_tvsd_data
        all_data = loader_fn(cfg, subjects=subjects, regions=regions)
        shared_test_ids = all_data["shared_test_ids"]
        neural = all_data["neural"]
        stimuli = all_data["stimuli"]
        present = [sid for sid in shared_test_ids if sid in stimuli]
        test_stimuli = (stimuli.subset(present) if hasattr(stimuli, "subset")
                        else {sid: stimuli[sid] for sid in present})
        dl_test = make_stimuli_loader(
            test_stimuli, get_transform("imgnet", normalize=not cfg.uint8_transfer),
            cfg.batchsize, cfg.num_workers)

        needed = sorted({best_layers[(r, str(s))] for r in regions for s in subjects})
        raw_acts, _ = extractor.extract_layers_exact(dl_test, needed, shared_test_ids)

        neural_rdms = {
            r: {s: compute_rdm(torch.as_tensor(np.stack(
                    [neural[r][s]["test"][sid] for sid in shared_test_ids
                     if sid in neural[r][s]["test"]]).squeeze().astype(np.float32),
                    device=device))
                for s in subjects}
            for r in regions
        }

        pcas = fit_layer_pcs(raw_acts, max(args.pca_k))
        for pca_k in args.pca_k:
            rprint(f"  --- pca_k = {pca_k} ---", style="info")
            model_rdms = {
                l: compute_rdm(reconstruct_from_pcs({l: a}, pcas, pca_k)[l].to(torch.float32))
                for l, a in raw_acts.items()
            }
            for region in regions:
                for subj in subjects:
                    layer = best_layers[(region, str(subj))]
                    score, lo, hi, boot = score_with_ci(
                        model_rdms[layer], neural_rdms[region][subj],
                        args.compare_method, cfg.n_bootstrap,
                    )
                    rprint(f"    {region} subj {subj} | {layer} = {score:.4f} "
                           f"[{lo:.4f}, {hi:.4f}]", style="highlight")
                    save_cfg = cfg.merge({"pca_k": pca_k, "region": region,
                                          "subject_idx": subj,
                                          "reconstruct_from_pcs": True})
                    _save(save_cfg, layer, score, lo, hi, boot)


def run_things(args, device=None) -> None:
    """The sweep on THINGS' evaluation concepts (region and subject
    "N/A")."""
    from visreps_tpu_torch.analysis.alignment import (
        AlignmentData,
        prepare_concept_alignment,
        take_rows,
    )
    from visreps_tpu_torch.analysis.rsa import concept_average_exact
    from visreps_tpu_torch.data.neural import get_neural_loader

    device = resolve_device(device)
    for seed in args.seeds:
        rprint(f"\n  THINGS-BEHAVIOR | seed {seed}", style="info")
        best_layers = query_best_layers(
            "things-behavior", seed, args.cfg_id, args.checkpoint_dir,
            args.compare_method,
        )
        best_layer = best_layers[("N/A", "N/A")]

        cfg = build_cfg(args, seed, "things-behavior")
        cfg.region = "N/A"
        cfg.subject_idx = "N/A"
        extractor = _model(cfg, device)
        neural_data, dl = get_neural_loader(cfg)

        acts, ids = extractor.get_activations(dl)
        all_concepts = prepare_concept_alignment(cfg, acts, neural_data, ids)
        del acts

        rng = np.random.RandomState(42)
        n_concepts = all_concepts.neural.shape[0]
        perm = rng.permutation(n_concepts)
        eval_idx = perm[int(n_concepts * 0.2):]
        evaluation = AlignmentData(
            activations={l: take_rows(a, eval_idx) for l, a in all_concepts.activations.items()},
            neural=all_concepts.neural[eval_idx],
            stimulus_ids=[all_concepts.stimulus_ids[i] for i in eval_idx],
            concept_image_ids={
                all_concepts.stimulus_ids[i]:
                    all_concepts.concept_image_ids[all_concepts.stimulus_ids[i]]
                for i in eval_idx
            },
        )
        del all_concepts

        raw, raw_ids = extractor.extract_layers_exact(dl, [best_layer])
        raw_acts = raw[best_layer]
        neural_rdm = compute_rdm(torch.as_tensor(evaluation.neural, device=device))

        pcas = fit_layer_pcs({best_layer: raw_acts}, max(args.pca_k))
        for pca_k in args.pca_k:
            recon = reconstruct_from_pcs({best_layer: raw_acts}, pcas, pca_k)[best_layer]
            eval_acts = concept_average_exact(recon.cpu().numpy(), raw_ids, evaluation)
            model_rdm = compute_rdm(torch.as_tensor(eval_acts.astype(np.float32), device=device))
            score, lo, hi, boot = score_with_ci(
                model_rdm, neural_rdm, args.compare_method, cfg.n_bootstrap
            )
            rprint(f"    pca_k={pca_k} {best_layer} = {score:.4f} [{lo:.4f}, {hi:.4f}]",
                   style="highlight")
            save_cfg = cfg.merge({"pca_k": pca_k, "reconstruct_from_pcs": True})
            _save(save_cfg, best_layer, score, lo, hi, boot)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--datasets", nargs="*",
                        default=["nsd", "tvsd", "things-behavior"],
                        choices=list(DATASET_CONFIG))
    parser.add_argument("--checkpoint-dir", required=True)
    parser.add_argument("--checkpoint-model", default="checkpoint_epoch_20.pth")
    parser.add_argument("--cfg-id", default=1000)
    parser.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    parser.add_argument("--pca-k", type=int, nargs="+", default=list(range(1, 16)))
    parser.add_argument("--compare-method", default="spearman")
    parser.add_argument("--n-bootstrap", type=int, default=1000)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--num-workers", type=int, default=16)
    parser.add_argument("--uint8-transfer", action="store_true",
                        help="ship uint8 image batches, normalised on the device (4x fewer "
                             "bytes to copy and to keep in the decode cache)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    for ds in args.datasets:
        rprint(f"\n  RECONSTRUCTION ANALYSIS: {ds.upper()}", style="info")
        if ds in ("nsd", "tvsd"):
            run_nsd_tvsd(args, ds, device)
        else:
            run_things(args, device)


if __name__ == "__main__":
    main()
