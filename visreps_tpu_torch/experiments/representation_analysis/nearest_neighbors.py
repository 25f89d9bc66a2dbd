"""Nearest-neighbour retrieval compared between models (port of
``experiments/representation_analysis/nearest_neighbors.py``).

For one query image per class, the k cosine-nearest neighbours under each
model's features, and the same-class retrieval accuracy. The cosine
similarities of all queries are one product on the device; the ranking
(``argsort(-sims)``) and the seeded query pick stay numpy on the host, as
in the JAX package. The retrievals are written as JSON beside the grid
figure (green border = same class, red = different), which is drawn only
where matplotlib imports (PIL reads the images).

Usage:
  python -m visreps_tpu_torch.experiments.representation_analysis.nearest_neighbors \
      --features feats_a.npy feats_b.npy --labels labels.npy \
      [--image-paths paths.txt] --out nn_grid.png [--device cpu]
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np
import torch

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.device import input_device, resolve_device
from visreps_tpu_torch.experiments.neurips_2025.figutils import draw_or_report, write_series

PROG = "representation_analysis.nearest_neighbors"
SEED = 42


def _cosine_topk_scores(feats: torch.Tensor, query_idx: torch.Tensor) -> torch.Tensor:
    """(n, d) features, (q,) query rows → (q, n) cosine similarities
    with the self-similarity masked out (−inf)."""
    x = feats / (torch.linalg.vector_norm(feats, dim=1, keepdim=True) + 1e-12)
    sims = x[query_idx] @ x.T
    sims[torch.arange(query_idx.shape[0], device=sims.device), query_idx] = -torch.inf
    return sims


def retrieve(features, labels: np.ndarray, query_idx: np.ndarray, k: int, device=None):
    """Top-k neighbour indices and same-class retrieval accuracy per query."""
    device = resolve_device(input_device(features, device))
    feats = torch.as_tensor(features).to(device, torch.float32)
    sims = _cosine_topk_scores(feats, torch.as_tensor(np.asarray(query_idx), device=device))
    top_k = np.argsort(-sims.cpu().numpy(), axis=1)[:, :k]
    acc = np.array([
        np.mean(labels[top_k[i]] == labels[q]) for i, q in enumerate(query_idx)
    ])
    return top_k, acc


def pick_queries(labels: np.ndarray, img_paths, n_queries: int, rng) -> np.ndarray:
    """One query per class (preferring images that exist on disk)."""
    queries = []
    for c in np.unique(labels)[:n_queries]:
        class_idx = np.where(labels == c)[0]
        chosen = None
        if img_paths is not None:
            for cand in rng.permutation(class_idx)[:20]:
                if os.path.exists(str(img_paths[cand])):
                    chosen = cand
                    break
        queries.append(chosen if chosen is not None else rng.choice(class_idx))
    return np.asarray(queries)


def plot_grid(feats_list, names, labels, img_paths, query_idx, top_ks, k, out_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    n_rows = len(query_idx)
    n_cols = len(feats_list) * (k + 1)
    fig, axes = plt.subplots(n_rows, n_cols, figsize=(2.2 * n_cols, 2.5 * n_rows))
    axes = np.atleast_2d(axes)

    def show(ax, idx):
        path = None if img_paths is None else str(img_paths[idx])
        if path and os.path.exists(path):
            ax.imshow(Image.open(path).convert("RGB").resize((224, 224)))
        else:
            ax.set_facecolor("#f0f0f0")
            ax.text(0.5, 0.5, f"#{idx}", ha="center", va="center",
                    transform=ax.transAxes, color="#666666", fontsize=7)
        ax.set_xticks([])
        ax.set_yticks([])

    for row, q in enumerate(query_idx):
        for m, (name, tk) in enumerate(zip(names, top_ks)):
            off = m * (k + 1)
            ax = axes[row, off]
            show(ax, q)
            ax.set_title(f"Query (C{labels[q]})", fontsize=8)
            if row == 0:
                ax.text(0.5, 1.25, name, transform=ax.transAxes, ha="center",
                        fontsize=10, fontweight="bold")
            for i, nn_idx in enumerate(tk[row]):
                ax = axes[row, off + 1 + i]
                show(ax, nn_idx)
                same = labels[nn_idx] == labels[q]
                for spine in ax.spines.values():
                    spine.set_edgecolor("#2ecc71" if same else "#e74c3c")
                    spine.set_linewidth(3)
    plt.tight_layout()
    plt.savefig(out_path, dpi=150, bbox_inches="tight", facecolor="white")
    plt.close(fig)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--features", nargs="+", required=True)
    parser.add_argument("--labels", required=True)
    parser.add_argument("--image-paths", default=None,
                        help="text file, one image path per row (optional)")
    parser.add_argument("--names", nargs="+", default=None)
    parser.add_argument("--n-queries", type=int, default=4)
    parser.add_argument("--k", type=int, default=5)
    parser.add_argument("--out", default="nearest_neighbors.png")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    rng = np.random.RandomState(SEED)
    labels = np.load(args.labels)
    img_paths = None
    if args.image_paths:
        with open(args.image_paths) as f:
            img_paths = [line.strip() for line in f if line.strip()]
    names = args.names or [Path(f).stem for f in args.features]
    feats_list = [np.load(f) for f in args.features]

    query_idx = pick_queries(labels, img_paths, args.n_queries, rng)
    top_ks, stats = [], {}
    for name, feats in zip(names, feats_list):
        tk, acc = retrieve(feats, labels, query_idx, args.k, device=device)
        top_ks.append(tk)
        stats[name] = float(acc.mean())
        rprint(f"  {name}: same-class retrieval {acc.mean():.3f}", style="highlight")

    write_series(args.out, {"query_idx": query_idx, "accuracy": stats,
                            "top_k": dict(zip(names, top_ks))})
    if draw_or_report(PROG, args.out, plot_grid, feats_list, names, labels, img_paths,
                      query_idx, top_ks, args.k, args.out):
        rprint(f"Saved: {args.out}", style="success")
    return stats


if __name__ == "__main__":
    main()
