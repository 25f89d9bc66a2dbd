"""Every representation analysis in sequence on shared features (port of
``experiments/representation_analysis/run_all.py``):

1. dimensionality (eigenspectrum, participation ratio, Two-NN ID), all
   layers, on the device; ``dimensionality_summary.npz`` holds ``str(row)``
   of each row, as the JAX run writes it; with two models, the comparison
   figures;
2. variance ratio (within/between class) of the chosen layer;
3. nearest-neighbour retrieval of that layer, on the device;
4. fine-grained structure (2-D embedding within animals) of that layer.

Driven by per-model feature npz files ({layer: (N, d), labels}). Figures
are drawn only where matplotlib (and, for step 4, an embedding backend)
imports; their data is written first.

Usage:
  python -m visreps_tpu_torch.experiments.representation_analysis.run_all \\
      --features a.npz b.npz --names A B --out_dir DIR [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.device import resolve_device
from visreps_tpu_torch.experiments.representation_analysis.utils import (
    MODEL_NAMES,
    SEED,
    ensure_output_dir,
    load_feature_npz,
)


def run_dimensionality(feats_dicts, names, out_dir, device=None):
    """Every layer's metrics per model; the summary npz; with exactly two
    models, the comparison figures. Returns the rows."""
    from visreps_tpu_torch.experiments.representation_analysis.dim_metrics import (
        compute_all_metrics,
    )
    from visreps_tpu_torch.experiments.representation_analysis.dimensionality import (
        render_comparison,
    )

    rows, per_model = [], {}
    for name, feats in zip(names, feats_dicts):
        layers = list(feats)
        res = compute_all_metrics(feats, layers, device=device)
        per_model[name] = res
        for layer in layers:
            rows.append({
                "model": name, "layer": layer,
                "participation_ratio": res["pr"][layer],
                "n_components_90": res["n90"][layer],
                "twonn_id": res["twonn"][layer]["dimension"],
                "hoyer_sparsity": res["sparsity"][layer]["mean"],
                "fraction_active": res["sparsity"][layer]["frac_active"],
            })
            rprint(f"  {name}/{layer}: PR = {res['pr'][layer]:.1f}, "
                   f"Two-NN = {res['twonn'][layer]['dimension']:.1f}",
                   style="info")
    out = os.path.join(out_dir, "dimensionality_summary.npz")
    np.savez(out, rows=np.array([str(r) for r in rows]))
    if len(names) == 2:
        shared = [layer for layer in feats_dicts[0] if layer in feats_dicts[1]]
        render_comparison(per_model, shared, list(names[:2]), out_dir)
    return rows


def run_variance_ratio(feats_list, labels, names, out_dir):
    from visreps_tpu_torch.experiments.representation_analysis.variance_ratio import (
        variance_ratio_stats,
        write_and_plot,
    )

    stats = [variance_ratio_stats(f, labels) for f in feats_list]
    write_and_plot(stats, names, os.path.join(out_dir, "variance_ratio.png"))
    return stats


def run_nearest_neighbors(feats_list, labels, names, out_dir, k=5, n_queries=4, device=None):
    from visreps_tpu_torch.experiments.representation_analysis.nearest_neighbors import (
        pick_queries,
        retrieve,
    )

    rng = np.random.RandomState(SEED)
    fake_paths = [f"img_{i}.jpg" for i in range(len(labels))]
    queries = pick_queries(labels, fake_paths, n_queries, rng)
    results = {}
    for name, feats in zip(names, feats_list):
        _, acc = retrieve(feats, labels, queries, k, device=device)
        results[name] = float(acc.mean())
        rprint(f"  {name}: retrieval purity@{k} = {results[name]:.3f}",
               style="info")
    return results


def run_fine_grained(feats_list, sem_labels, synsets, names, out_dir):
    from visreps_tpu_torch.experiments.semantic_analysis.fine_grained_structure import (
        analyze_fine_grained_structure,
    )

    return analyze_fine_grained_structure(
        feats_list, sem_labels, synsets,
        os.path.join(out_dir, "fine_grained_animals.png"), model_names=names)


def main(argv=None):
    """Returns {"dimensionality": rows, "variance_ratio": stats,
    "nearest_neighbors": accuracies, "fine_grained": n_animals} of the
    steps that ran."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--features", nargs="+", required=True,
                        help="npz per model: {<layers>: (N,d), labels}")
    parser.add_argument("--names", nargs="+", default=MODEL_NAMES)
    parser.add_argument("--layer", default="fc2")
    parser.add_argument("--sem_labels", help=".npy semantic labels (fine-grained step)")
    parser.add_argument("--synsets", help=".npy synset ids (fine-grained step)")
    parser.add_argument("--out_dir", default=None)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    np.random.seed(SEED)
    out_dir = ensure_output_dir(args.out_dir)
    names = args.names[: len(args.features)]
    feats_dicts, labels = [], None
    for p in args.features:
        f, lab = load_feature_npz(p)
        feats_dicts.append(f)
        labels = lab if lab is not None else labels
    fc2 = [f[args.layer] for f in feats_dicts]
    out = {}

    rprint("=== 1. Dimensionality (all layers) ===", style="info")
    out["dimensionality"] = run_dimensionality(feats_dicts, names, out_dir, device)

    if labels is not None:
        rprint("=== 2. Variance ratio (FC2) ===", style="info")
        out["variance_ratio"] = run_variance_ratio(fc2, labels, names, out_dir)
        rprint("=== 3. Nearest neighbors (FC2) ===", style="info")
        out["nearest_neighbors"] = run_nearest_neighbors(fc2, labels, names, out_dir,
                                                         device=device)

    if args.sem_labels and args.synsets:
        rprint("=== 4. Fine-grained structure (FC2) ===", style="info")
        out["fine_grained"] = run_fine_grained(
            fc2, np.load(args.sem_labels), np.load(args.synsets, allow_pickle=True),
            names, out_dir)
    rprint("Done.", style="success")
    return out


if __name__ == "__main__":
    main()
