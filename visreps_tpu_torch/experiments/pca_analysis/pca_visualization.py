"""PC1–PC2 scatter and 1-D PC densities coloured by the coarse labels
(port of ``experiments/pca_analysis/pca_visualization.py``).

Source-model features projected onto the coarse-grain pipeline's
eigenvectors npz (``eigenvectors``, ``mean``) for a 5 % sample (numpy
``RandomState(42)``), as host numpy like the JAX program. The sampled
scores and labels are written as an npz beside the scatter and the
four 80-bin densities as JSON beside their grid; both figures are drawn
only where matplotlib imports.

Usage:
  python -m visreps_tpu_torch.experiments.pca_analysis.pca_visualization \\
      --features features_alexnet.npz --eigenvectors eigenvectors_alexnet.npz \\
      --labels_dir pca_labels/pca_labels_alexnet_hierarchical --n_classes 4 --out_dir results
"""
from __future__ import annotations

import argparse
import csv
import os
from pathlib import Path

import numpy as np

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.experiments.neurips_2025.figutils import draw_or_report, write_series

SEED = 42
PROG = "pca_analysis.pca_visualization"
N_BINS = 80


def load_scores_and_labels(features_path: str, eigenvectors_path: str, labels_csv: str,
                           sample_fraction: float = 0.05, n_pcs: int = 4, seed: int = SEED):
    """(sampled PC scores, sampled labels)."""
    pca = np.load(eigenvectors_path)
    eigenvectors, mean = pca["eigenvectors"][:, :n_pcs], pca["mean"]

    data = np.load(features_path, allow_pickle=True)
    names = data["image_names"]
    if names.size and isinstance(names[0], (bytes, np.bytes_)):
        names = np.array([n.decode() for n in names])
    names = np.array([os.path.basename(str(n)) for n in names])
    for key in ("fc2", "clip_features", "features", "dreamsim_features"):
        if key in data:
            features = data[key].reshape(len(names), -1)
            break

    with open(labels_csv) as f:
        label_of = {r["image"]: int(r["pca_label"]) for r in csv.DictReader(f)}
    labels = np.array([label_of[n] for n in names])

    rng = np.random.RandomState(seed)
    n_samples = max(1, int(len(names) * sample_fraction))
    idx = rng.choice(len(names), n_samples, replace=False)
    scores = (features[idx] - mean) @ eigenvectors
    return scores, labels[idx]


def densities(scores: np.ndarray, n_pcs: int = 4) -> dict:
    """{"PC{i}": {"density", "edges"}}: the 80-bin density histograms the
    1-D figure draws."""
    out = {}
    for i in range(n_pcs):
        density, edges = np.histogram(scores[:, i], bins=N_BINS, density=True)
        out[f"PC{i + 1}"] = {"density": density, "edges": edges}
    return out


def plot_scatter(scores, labels, n_classes, out_path, title_prefix="AlexNet fc2"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 8))
    colors = plt.cm.Spectral(np.linspace(0.05, 0.95, n_classes))
    for c in range(n_classes):
        m = labels == c
        ax.scatter(scores[m, 0], scores[m, 1], c=[colors[c]],
                   label=f"Class {c} (n={int(m.sum()):,})", alpha=0.6, s=10,
                   edgecolors="none")
    ax.set_xlabel("PC1"), ax.set_ylabel("PC2")
    ax.set_title(f"{title_prefix} Features on PC1-PC2 ({n_classes} hierarchical classes)")
    ax.legend(loc="best", fontsize=9, ncol=2 if n_classes > 4 else 1, framealpha=0.9)
    ax.grid(True, alpha=0.3, linestyle="--")
    ax.set_facecolor("#FAFAFA")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    plt.tight_layout()
    plt.savefig(out_path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    rprint(f"Saved to {out_path}", style="success")


def plot_1d_distributions(scores, out_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(10, 8))
    colors = ["#E24A33", "#348ABD", "#988ED5", "#8EBA42"]
    for i, ax in enumerate(axes.flat):
        ax.hist(scores[:, i], bins=N_BINS, alpha=0.7, color=colors[i], density=True)
        ax.set_xlabel(f"PC{i + 1}"), ax.set_ylabel("Density")
        ax.set_title(f"Distribution along PC{i + 1}")
        ax.grid(True, alpha=0.3, linestyle="--")
        ax.set_facecolor("#FAFAFA")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    plt.tight_layout()
    plt.savefig(out_path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    rprint(f"Saved to {out_path}", style="success")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--features", default="datasets/obj_cls/imagenet/features_alexnet.npz")
    parser.add_argument("--eigenvectors",
                        default="datasets/obj_cls/imagenet/eigenvectors_alexnet.npz")
    parser.add_argument("--labels_dir", default="pca_labels/pca_labels_alexnet_hierarchical")
    parser.add_argument("--n_classes", type=int, default=4)
    parser.add_argument("--sample_fraction", type=float, default=0.05)
    parser.add_argument("--out_dir", default="experiments/results")
    args = parser.parse_args(argv)

    labels_csv = os.path.join(args.labels_dir, f"n_classes_{args.n_classes}.csv")
    scores, labels = load_scores_and_labels(args.features, args.eigenvectors, labels_csv,
                                            args.sample_fraction)
    scatter = os.path.join(args.out_dir, f"pca_pc1pc2_{args.n_classes}classes.png")
    dists = os.path.join(args.out_dir, "pca_1d_distributions.png")
    os.makedirs(args.out_dir, exist_ok=True)
    np.savez(Path(scatter).with_suffix(".npz"), scores=scores, labels=labels)
    write_series(dists, densities(scores))
    draw_or_report(PROG, scatter, plot_scatter, scores, labels, args.n_classes, scatter)
    draw_or_report(PROG, dists, plot_1d_distributions, scores, dists)
    return scores, labels


if __name__ == "__main__":
    main()
