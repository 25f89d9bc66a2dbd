"""Fine-grained structure within animals: a 2-D embedding by synset (port
of ``experiments/semantic_analysis/fine_grained_structure.py``).

The animal images (semantic label 0), the top-k synsets among them, and
each model's animal rows L2-normalised (numpy, as in the JAX package) are
the data the figure embeds: they are written as an npz beside the figure
first (``fine_grained_data``), then embedded (umap, else sklearn t-SNE)
and drawn only where matplotlib and an embedding backend both import.

Usage:
  python -m visreps_tpu_torch.experiments.semantic_analysis.fine_grained_structure \\
      --features a.npz b.npz --sem_labels sem.npy --synsets syn.npy --out fg.png
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
    MODEL_NAMES,
    SEED,
    embedding_backend,
    ensure_output_dir,
    load_feature_npz,
)

PROG = "semantic_analysis.fine_grained_structure"


def fine_grained_data(feats_list, sem_labels, synsets, animal_label: int = 0,
                      top_k: int = 15) -> dict:
    """{"animal_mask", "animal_synsets", "top_synsets", "rows": [(n_animals,
    d) L2-normalised rows per model]}: what the figure embeds."""
    animal_mask = sem_labels == animal_label
    animal_synsets = synsets[animal_mask]
    unique, counts = np.unique(animal_synsets, return_counts=True)
    rows = []
    for feats in feats_list:
        fa = feats[animal_mask]
        rows.append(fa / np.maximum(np.linalg.norm(fa, axis=1, keepdims=True), 1e-8))
    return {"animal_mask": animal_mask, "animal_synsets": animal_synsets,
            "top_synsets": unique[np.argsort(counts)[::-1][:top_k]], "rows": rows}


def write_data(data: dict, model_names, output_path: str) -> str:
    """The embedded data as ``<figure>.npz``: the mask, synsets and one
    ``rows_<i>`` array per model, with ``model_names``."""
    path = str(Path(output_path).with_suffix(".npz"))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, animal_mask=data["animal_mask"], animal_synsets=data["animal_synsets"],
             top_synsets=data["top_synsets"], model_names=np.asarray(list(model_names)),
             **{f"rows_{i}": r for i, r in enumerate(data["rows"])})
    return path


def draw(data: dict, model_names, output_path: str, top_k: int):
    """Embed each model's rows and draw the panels, coloured by the top
    synsets."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    top, animal_synsets = data["top_synsets"], data["animal_synsets"]
    color_of = {s: i for i, s in enumerate(top)}
    cmap = plt.cm.tab20(np.linspace(0, 1, 20))
    fig, axes = plt.subplots(1, len(data["rows"]),
                             figsize=(8 * len(data["rows"]), 7), squeeze=False)
    for ax, fa, name in zip(axes[0], data["rows"], model_names):
        coords, method_name = utils.embed_2d(fa, seed=SEED)
        for s in top:
            m = animal_synsets == s
            ax.scatter(coords[m, 0], coords[m, 1], c=[cmap[color_of[s]]],
                       alpha=0.6, s=15, label=str(s)[:10])
        other = ~np.isin(animal_synsets, top)
        ax.scatter(coords[other, 0], coords[other, 1], c="lightgray",
                   alpha=0.3, s=5, label="other")
        ax.set_xlabel(f"{method_name} 1")
        ax.set_ylabel(f"{method_name} 2")
        ax.set_title(name, fontweight="bold")
        ax.set_facecolor("#FAFAFA")

    handles, labels = axes[0][0].get_legend_handles_labels()
    fig.legend(handles[:top_k], labels[:top_k], loc="center right",
               bbox_to_anchor=(1.12, 0.5), fontsize=8, title="Synset (Animal)")
    plt.suptitle(
        f"Fine-Grained Structure Within Animals (top {top_k} synsets)",
        fontweight="bold")
    plt.tight_layout(rect=[0, 0, 0.88, 1])
    plt.savefig(output_path, dpi=200, bbox_inches="tight", facecolor="white")
    plt.close(fig)


def analyze_fine_grained_structure(feats_list, sem_labels, synsets,
                                   output_path, model_names=None,
                                   animal_label: int = 0, top_k: int = 15,
                                   min_images: int = 50):
    """Write the animal-only data, then embed and draw it where matplotlib
    and an embedding backend import. Returns n_animals (and does nothing
    else below ``min_images``)."""
    model_names = model_names or MODEL_NAMES
    n_animals = int((sem_labels == animal_label).sum())
    rprint(f"  Animals: {n_animals} images", style="info")
    if n_animals < min_images:
        rprint("  Not enough animal images for an embedding", style="warning")
        return n_animals

    data = fine_grained_data(feats_list, sem_labels, synsets, animal_label, top_k)
    rprint(f"  Saved data: {write_data(data, model_names, output_path)}", style="success")
    if not matplotlib_available() or embedding_backend() is None:
        print(f"{PROG}: matplotlib or an embedding backend (umap, sklearn) is not "
              f"installed; nothing embedded, {output_path} not drawn", flush=True)
        return n_animals
    draw(data, model_names, output_path, top_k)
    rprint(f"Saved: {output_path}", style="success")
    return n_animals


def main(argv=None):
    """Returns n_animals."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--features", nargs="+", required=True,
                        help="npz per model: {<layer>: feats, labels}")
    parser.add_argument("--layer", default="fc2")
    parser.add_argument("--sem_labels", required=True, help=".npy of semantic labels")
    parser.add_argument("--synsets", required=True, help=".npy of synset ids")
    parser.add_argument("--names", nargs="+", default=None)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    np.random.seed(SEED)
    feats_list = [load_feature_npz(p)[0][args.layer] for p in args.features]
    sem_labels = np.load(args.sem_labels)
    synsets = np.load(args.synsets, allow_pickle=True)
    out = args.out or os.path.join(ensure_output_dir(), "fine_grained_animals.png")
    return analyze_fine_grained_structure(feats_list, sem_labels, synsets, out,
                                          model_names=args.names)


if __name__ == "__main__":
    main()
