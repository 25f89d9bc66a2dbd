"""2-D embedding grid of FC2 features across training granularities
(port of ``experiments/semantic_analysis/plot_semantic_classes_umap.py``).

For each of the 4/8/16/32/64/1000-way models, FC2 features L2-normalised
(numpy), embedded in 2-D (umap, else sklearn t-SNE) and coloured by the
8 semantic super-categories, as a (2, 3) grid with one shared legend and
percentile zoom. The normalised rows and labels are written as an npz
beside the figure first; the embedding and the drawing happen only where
matplotlib and an embedding backend both import.

Usage:
  python -m visreps_tpu_torch.experiments.semantic_analysis.plot_semantic_classes_umap \
      --features m4.npz m8.npz - ... --labels sem.npy --out grid.png
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.experiments.neurips_2025.figutils import matplotlib_available
from visreps_tpu_torch.experiments.representation_analysis import utils
from visreps_tpu_torch.experiments.representation_analysis.utils import (
    SEED,
    embedding_backend,
    load_feature_npz,
)
from visreps_tpu_torch.experiments.wordnet.make_semantic_labels import SUPER_CATEGORIES

PROG = "semantic_analysis.plot_semantic_classes_umap"

CATEGORY_NAMES = list(SUPER_CATEGORIES.keys())
ZOOM_PERCENTILE = 2
POINT_SIZE = 2
POINT_ALPHA = 0.5
DEFAULT_NAMES = ["4-way", "8-way", "16-way", "32-way", "64-way", "1000-way"]


def generate_category_colors(n: int):
    import matplotlib.pyplot as plt

    cmap = plt.cm.tab10 if n <= 10 else (plt.cm.tab20 if n <= 20 else plt.cm.nipy_spectral)
    return [cmap(i / max(n - 1, 1)) for i in range(n)]


def l2_normalize(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-8)


def plot_grid(all_coords, labels, model_names, output_path,
              method_name: str = "UMAP"):
    """(2, ceil(n/2)) grid of embeddings with one shared legend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.lines import Line2D

    colors = generate_category_colors(len(CATEGORY_NAMES))
    n = len(all_coords)
    ncols = -(-n // 2)
    fig, axes = plt.subplots(2, ncols, figsize=(5 * ncols, 10), squeeze=False)
    axes = axes.flatten()
    unique_labels = np.unique(labels[labels >= 0])

    for ax, coords, name in zip(axes, all_coords, model_names):
        if coords is None:
            ax.text(0.5, 0.5, f"{name}\n(not available)", ha="center",
                    va="center", transform=ax.transAxes)
            ax.set_xticks([]), ax.set_yticks([])
            continue
        for label in unique_labels:
            m = labels == label
            c = colors[label] if label < len(colors) else "#000000"
            ax.scatter(coords[m, 0], coords[m, 1], c=[c], alpha=POINT_ALPHA,
                       s=POINT_SIZE, edgecolors="none", rasterized=True)
        if ZOOM_PERCENTILE is not None:
            xlim = np.percentile(coords[:, 0], [ZOOM_PERCENTILE, 100 - ZOOM_PERCENTILE])
            ylim = np.percentile(coords[:, 1], [ZOOM_PERCENTILE, 100 - ZOOM_PERCENTILE])
            xpad, ypad = (xlim[1] - xlim[0]) * 0.1, (ylim[1] - ylim[0]) * 0.1
            ax.set_xlim(xlim[0] - xpad, xlim[1] + xpad)
            ax.set_ylim(ylim[0] - ypad, ylim[1] + ypad)
        ax.set_xlabel(f"{method_name} 1")
        ax.set_ylabel(f"{method_name} 2")
        ax.set_title(name, fontweight="bold")
        ax.set_facecolor("#FAFAFA")
    for ax in axes[n:]:
        ax.axis("off")

    legend = [
        Line2D([0], [0], marker="o", color="w", markerfacecolor=colors[i],
               markersize=10, label=CATEGORY_NAMES[i])
        for i in range(len(CATEGORY_NAMES))
    ]
    fig.legend(handles=legend, loc="center right", bbox_to_anchor=(0.99, 0.5),
               title="Semantic Category", frameon=True)
    plt.suptitle(
        f"{method_name} of FC2 Features Across Training Granularities",
        fontweight="bold", y=1.02)
    plt.tight_layout(rect=[0, 0, 0.88, 1])
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    plt.savefig(output_path, dpi=200, bbox_inches="tight", facecolor="white")
    plt.close(fig)
    rprint(f"Saved to {output_path}", style="success")


def write_data(rows_list, labels, model_names, output_path: str) -> str:
    """The embedded data as ``<figure>.npz``: the labels, ``model_names``,
    and ``rows_<i>`` per model present (a missing model has no array)."""
    path = str(Path(output_path).with_suffix(".npz"))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, labels=labels, model_names=np.asarray(list(model_names)),
             **{f"rows_{i}": r for i, r in enumerate(rows_list) if r is not None})
    return path


def run(features_list, labels, model_names, output_path):
    """Normalise and write the data, then embed and draw where matplotlib
    and an embedding backend import; ``features_list`` entries may be None
    (missing). Returns the coordinates per model (None where missing or
    not embedded)."""
    valid = labels >= 0
    rows_list = [None if feats is None else l2_normalize(feats[valid])
                 for feats in features_list]
    rprint(f"  Saved data: {write_data(rows_list, labels[valid], model_names, output_path)}",
           style="success")
    if not matplotlib_available() or embedding_backend() is None:
        print(f"{PROG}: matplotlib or an embedding backend (umap, sklearn) is not "
              f"installed; nothing embedded, {output_path} not drawn", flush=True)
        return [None] * len(rows_list)
    coords_list, method_name = [], "2D"
    for name, rows in zip(model_names, rows_list):
        if rows is None:
            coords_list.append(None)
            continue
        rprint(f"  embedding {name}...", style="info")
        coords, method_name = utils.embed_2d(rows, seed=SEED)
        coords_list.append(coords)
    plot_grid(coords_list, labels[valid], model_names, output_path, method_name)
    return coords_list


def main(argv=None):
    """Returns the coordinates per model."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--features", nargs="+", required=True,
                        help="npz per model ({fc2: feats}); '-' for missing")
    parser.add_argument("--layer", default="fc2")
    parser.add_argument("--labels", required=True,
                        help=".npy of semantic labels aligned to features rows")
    parser.add_argument("--names", nargs="+", default=DEFAULT_NAMES)
    parser.add_argument("--out", default="semantic_classes_umap.png")
    args = parser.parse_args(argv)

    np.random.seed(SEED)
    feats = [None if p == "-" else load_feature_npz(p)[0][args.layer]
             for p in args.features]
    labels = np.load(args.labels)
    return run(feats, labels, args.names[: len(feats)], args.out)


if __name__ == "__main__":
    main()
