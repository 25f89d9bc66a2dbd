"""Within-class against between-class spread of representations (port of
``experiments/representation_analysis/variance_ratio.py``).

Per model, each class's distances to its centroid (within) and the
centroids' distances from the global mean (between); their ratio
measures cluster tightness. numpy on the host, as in the JAX package.
The statistics are written as JSON beside the box-plot figure, which is
drawn only where matplotlib imports.

Usage:
  python -m visreps_tpu_torch.experiments.representation_analysis.variance_ratio \
      --features feats_a.npy feats_b.npy --labels labels.npy \
      --names "Pretrained (1000-way)" "32-way Trained" --out variance_ratio.png
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.experiments.neurips_2025.figutils import draw_or_report, write_series

PROG = "representation_analysis.variance_ratio"


def variance_ratio_stats(features: np.ndarray, labels: np.ndarray) -> dict:
    """Within/between-class variance stats for one model's features.

    Returns {"within", "between", "ratio", "within_per_class", "classes"};
    numpy on the host, as in the JAX package.
    """
    classes = np.unique(labels)
    centroids = np.stack([features[labels == c].mean(axis=0) for c in classes])
    global_mean = features.mean(axis=0)

    within_per_class = [
        np.linalg.norm(features[labels == c] - centroids[i], axis=1)
        for i, c in enumerate(classes)
    ]
    between = float(np.mean(np.linalg.norm(centroids - global_mean, axis=1)))
    within = float(np.mean([w.mean() for w in within_per_class]))
    return {
        "within": within,
        "between": between,
        "ratio": between / within if within > 0 else 0.0,
        "within_per_class": within_per_class,
        "classes": classes,
    }


def plot_variance_ratio(stats_list, names, out_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, len(stats_list), figsize=(7 * len(stats_list), 5))
    if len(stats_list) == 1:
        axes = [axes]
    for ax, stats, name in zip(axes, stats_list, names):
        ax.boxplot(stats["within_per_class"],
                   tick_labels=[f"Class {c}" for c in stats["classes"]],
                   patch_artist=True)
        ax.set_xlabel("Class")
        ax.set_ylabel("Distance to Class Centroid")
        ax.set_title(f"{name}\nB/W Ratio: {stats['ratio']:.2f}", fontweight="bold")
        ax.set_facecolor("#FAFAFA")
    plt.suptitle("Cluster Tightness: Distance to Class Centroid", fontweight="bold")
    plt.tight_layout()
    plt.savefig(out_path, dpi=200, bbox_inches="tight", facecolor="white")
    plt.close(fig)


def write_and_plot(stats_list, names, out_path) -> bool:
    """The statistics as JSON beside ``out_path``, then the figure where
    matplotlib imports. Returns whether it drew."""
    write_series(out_path, {name: {k: s[k] for k in ("within", "between", "ratio",
                                                     "within_per_class", "classes")}
                            for name, s in zip(names, stats_list)})
    return draw_or_report(PROG, out_path, plot_variance_ratio, stats_list, names, out_path)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--features", nargs="+", required=True,
                        help=".npy feature arrays, one per model")
    parser.add_argument("--labels", required=True, help=".npy integer labels")
    parser.add_argument("--names", nargs="+", default=None)
    parser.add_argument("--out", default="variance_ratio.png")
    args = parser.parse_args(argv)

    labels = np.load(args.labels)
    names = args.names or [Path(f).stem for f in args.features]
    stats_list = []
    for path, name in zip(args.features, names):
        stats = variance_ratio_stats(np.load(path), labels)
        stats_list.append(stats)
        rprint(
            f"  {name}: Within={stats['within']:.2f}, Between={stats['between']:.2f}, "
            f"Ratio={stats['ratio']:.2f}",
            style="highlight",
        )
    if write_and_plot(stats_list, names, args.out):
        rprint(f"Saved: {args.out}", style="success")
    return stats_list


if __name__ == "__main__":
    main()
