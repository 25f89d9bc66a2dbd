"""Curriculum RSA: per-layer NSD alignment of trained checkpoints (port of
``experiments/coarse_grain_benefits/curriculum_nsd_rsa.py``).

For each checkpoint (e.g. 1K-way scratch, 64-way coarse, 64→1K
curriculum) and subject: SRP activations of every layer on the
subject's NSD train stimuli (the float32 store, moved to the device),
then every layer's RDM scored against each region's neural RDM with no
selection (``analysis/rsa.select_best_layer``: one RDM kernel launch per
layer RDM and one per neural RDM, on the card); the rows go to a CSV and
the two-panel RSA-by-normalised-depth figure is drawn when matplotlib
imports (a missing matplotlib is reported on a line of its own).

Usage:
  python -m visreps_tpu_torch.experiments.coarse_grain_benefits.curriculum_nsd_rsa \\
      --checkpoints "1K=ckpts/default/cfg1000a/checkpoint_epoch_20.pth" \\
                    "64=ckpts/pca/cfg64a/checkpoint_epoch_20.pth" \\
      --subjects 0 1 --out-dir results/ [--device cpu]
"""
from __future__ import annotations

import argparse
import csv
import os

import numpy as np

from visreps_tpu_torch.core.config import Config
from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.device import resolve_device

REGIONS = ["early visual stream", "ventral visual stream"]
LAYERS = ["conv1", "conv2", "conv3", "conv4", "conv5", "fc1", "fc2"]


def normalized_depth(layer_names):
    n = len(layer_names)
    return {name: i / (n - 1) for i, name in enumerate(layer_names)}


def subject_activations(extractor, subject_idx: int, batch_size: int, num_workers: int):
    """({layer: (N, k) float32 on the extractor's device}, ids) over the
    subject's NSD train stimuli."""
    from visreps_tpu_torch.data.loader import make_stimuli_loader
    from visreps_tpu_torch.data.neural import load_nsd_data
    from visreps_tpu_torch.data.transforms import get_transform

    cfg = Config({"neural_dataset": "nsd", "region": REGIONS[0], "subject_idx": subject_idx})
    targets0, stimuli = load_nsd_data(cfg)
    train = stimuli.subset([sid for sid in targets0["train"] if sid in stimuli])
    dl = make_stimuli_loader(train, get_transform("imgnet"), batch_size, num_workers)
    acts, ids = extractor.get_activations(dl, store="host")
    return {name: a.to(extractor.device) for name, a in acts.items()}, ids


def score_layers(acts: dict, ids, subject_idx: int, compare_method: str) -> list[dict]:
    """Rows (region, subject_idx, layer, score) of every layer against
    each region's train-set neural RDM."""
    from visreps_tpu_torch.analysis.alignment import align_stimulus_level
    from visreps_tpu_torch.analysis.rsa import select_best_layer
    from visreps_tpu_torch.data.neural import load_nsd_data

    rows = []
    for region in REGIONS:
        cfg_r = Config({"neural_dataset": "nsd", "region": region, "subject_idx": subject_idx})
        targets, _ = load_nsd_data(cfg_r)
        a, neural, _ = align_stimulus_level(acts, targets["train"], ids)
        scores = select_best_layer(a, neural, compare_method)
        for layer, score in scores.items():
            rows.append({"region": region, "subject_idx": subject_idx,
                         "layer": layer, "score": score})
            rprint(f"    subj {subject_idx} {region} {layer}: {score:.4f}", style="info")
    return rows


def score_model(ckpt_path: str, subjects, compare_method: str, batch_size: int,
                num_workers: int, srp_k: int, device=None):
    """Per-(region, subject, layer) RSA scores for one checkpoint."""
    from visreps_tpu_torch.models.extractor import FeatureExtractor
    from visreps_tpu_torch.train.checkpoint import load_checkpoint

    device = resolve_device(device)
    model, _ = load_checkpoint(ckpt_path, device=device)
    extractor = FeatureExtractor(model, LAYERS, extract_pre_and_post=False, srp_k=srp_k,
                                 image_size=224, device=device)
    rows = []
    for subject_idx in subjects:
        acts, ids = subject_activations(extractor, subject_idx, batch_size, num_workers)
        rows.extend(score_layers(acts, ids, subject_idx, compare_method))
    return rows


def plot_results(rows_by_model: dict, out_png: str):
    """Two-panel RSA-by-depth plot."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    depth = normalized_depth(LAYERS)
    fig, axes = plt.subplots(1, 2, figsize=(10, 3.2))
    styles = ["-", "--", "-."]
    markers = ["o", "o", "D"]
    for ax, region in zip(axes, REGIONS):
        for i, (name, rows) in enumerate(rows_by_model.items()):
            xs, means, sems = [], [], []
            for layer in LAYERS:
                vals = [r["score"] for r in rows
                        if r["region"] == region and r["layer"] == layer]
                if not vals:
                    continue
                xs.append(depth[layer])
                means.append(np.mean(vals))
                sems.append(np.std(vals) / max(np.sqrt(len(vals)), 1))
            ax.errorbar(xs, means, yerr=sems, label=name,
                        linestyle=styles[i % 3], marker=markers[i % 3], ms=4)
        ax.set_title(region)
        ax.set_xlabel("Normalized depth")
        ax.set_ylabel("RSA score")
    axes[-1].legend(loc="center left", bbox_to_anchor=(1.02, 0.5), fontsize=8)
    plt.tight_layout()
    plt.savefig(out_png, dpi=200, bbox_inches="tight")
    plt.close(fig)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoints", nargs="+", required=True,
                        help="name=path pairs")
    parser.add_argument("--subjects", type=int, nargs="+", default=list(range(8)))
    parser.add_argument("--compare-method", default="spearman")
    parser.add_argument("--srp-k", type=int, default=4096)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--num-workers", type=int, default=4)
    parser.add_argument("--out-dir",
                        default="experiments/coarse_grain_benefits/results")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    rows_by_model = {}
    all_rows = []
    for spec in args.checkpoints:
        name, _, path = spec.partition("=")
        rprint(f"\n=== {name} ({path}) ===", style="info")
        rows = score_model(path, args.subjects, args.compare_method,
                           args.batch_size, args.num_workers, args.srp_k, device)
        rows_by_model[name] = rows
        for r in rows:
            all_rows.append({"model_name": name, **r})

    out_csv = os.path.join(args.out_dir, "curriculum_nsd_rsa.csv")
    with open(out_csv, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(all_rows[0].keys()))
        writer.writeheader()
        writer.writerows(all_rows)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("curriculum_nsd_rsa: matplotlib is not installed; no figure drawn", flush=True)
    else:
        plot_results(rows_by_model, os.path.join(args.out_dir, "curriculum_rsa_comparison.png"))
    rprint(f"Saved {len(all_rows)} rows -> {out_csv}", style="success")
    return all_rows


if __name__ == "__main__":
    main()
