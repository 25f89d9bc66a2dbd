"""Class-size distribution of a PCA-label CSV (port of
``experiments/pca_analysis/visualize_class_distribution.py``).

Images per class, sorted in descending order, and the summary line
(classes, images, median, range). The counts, the log-spaced histogram
bins, the top-N and bottom-N panels and the summary are written as JSON
beside the figure, which is drawn only where matplotlib imports.

Usage:
  python -m visreps_tpu_torch.experiments.pca_analysis.visualize_class_distribution \\
      --labels pca_labels/pca_labels_alexnet/n_classes_64.csv --out class_distribution.png
"""
from __future__ import annotations

import argparse
import csv
from collections import Counter
from pathlib import Path

import numpy as np

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.experiments.neurips_2025.figutils import draw_or_report, write_series

PROG = "pca_analysis.visualize_class_distribution"


def class_counts_from_csv(path: str) -> np.ndarray:
    with open(path) as f:
        counts = Counter(row["pca_label"] for row in csv.DictReader(f))
    return np.asarray(sorted(counts.values(), reverse=True))


def _panels(class_counts: np.ndarray, n_show: int):
    """(n_show, top counts, bottom counts, log-spaced histogram bins)."""
    n_show = max(1, min(n_show, len(class_counts) // 2 or 1))
    log_min = np.floor(np.log10(max(class_counts.min(), 1)))
    log_max = np.ceil(np.log10(class_counts.max()))
    bins = np.logspace(log_min, max(log_max, log_min + 1), 25)
    return n_show, class_counts[:n_show], class_counts[-n_show:], bins


def summary_line(class_counts: np.ndarray) -> str:
    return (f"{len(class_counts):,} classes  ·  {int(class_counts.sum()):,} images  ·  "
            f"Median: {np.median(class_counts):.0f}  ·  "
            f"Range: {class_counts.min()}-{class_counts.max()}")


def distribution_data(class_counts: np.ndarray, n_show: int = 16) -> dict:
    """What the figure draws: the counts, the histogram's bins and counts,
    the top and bottom panels and the summary."""
    n_show, top_n, bottom_n, bins = _panels(class_counts, n_show)
    return {"counts": class_counts, "bins": bins,
            "histogram": np.histogram(class_counts, bins=bins)[0],
            "n_show": n_show, "top": top_n, "bottom": bottom_n,
            "summary": summary_line(class_counts)}


def plot_distribution(class_counts: np.ndarray, out_path: str, n_show: int = 16):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n_show, top_n, bottom_n, bins = _panels(class_counts, n_show)
    fig, axes = plt.subplots(1, 3, figsize=(16, 5), gridspec_kw={"width_ratios": [1.2, 1, 1]})

    ax = axes[0]
    ax.hist(class_counts, bins=bins, edgecolor="white", linewidth=0.8, alpha=0.9,
            color="#6b7280")
    ax.set_xscale("log")
    ax.set_xlabel("Images per class")
    ax.set_ylabel("Number of classes")
    ax.set_title("Class Size Distribution", fontweight="bold")

    for ax, vals, cmap, title in (
        (axes[1], top_n, plt.cm.Oranges, f"Top {n_show} Classes"),
        (axes[2], bottom_n, plt.cm.Blues, f"Bottom {n_show} Classes"),
    ):
        colors = cmap(np.linspace(0.4, 0.9, len(vals)))[::-1]
        ax.bar(range(len(vals)), vals, color=colors, edgecolor="white", linewidth=0.5)
        ax.set_xlabel("Rank")
        ax.set_ylabel("Number of images")
        ax.set_title(title, fontweight="bold")

    fig.suptitle(summary_line(class_counts), fontsize=10, color="#555", y=0.02)
    plt.tight_layout(rect=[0, 0.05, 1, 1])
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(out_path, dpi=150, facecolor="white", bbox_inches="tight")
    plt.close(fig)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--labels", required=True, help="pca labels CSV (image,pca_label)")
    parser.add_argument("--out", default="class_distribution.png")
    parser.add_argument("--n-show", type=int, default=16)
    args = parser.parse_args(argv)

    counts = class_counts_from_csv(args.labels)
    write_series(args.out, distribution_data(counts, args.n_show))
    draw_or_report(PROG, args.out, plot_distribution, counts, args.out, args.n_show)
    rprint(f"{len(counts)} classes, {counts.sum()} images, median {np.median(counts):.0f} "
           f"-> {args.out}", style="success")
    return counts


if __name__ == "__main__":
    main()
