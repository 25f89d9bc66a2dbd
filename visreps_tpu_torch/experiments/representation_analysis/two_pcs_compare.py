"""PC1–PC2 quadrant comparison of a pretrained and a coarse-trained
AlexNet (port of ``experiments/representation_analysis/two_pcs_compare.py``).

conv4 / fc1 / fc2 taps (conv pooled 3×3, rows L2-normalised), each
model's top 2 PCs by a device ``eigh`` of the d × d covariance, 4
quadrant classes by median splits of the PRETRAINED PCs, and the trained
PCs aligned (sign and order, 8 configurations scored against the
expected quadrant layout); the npz is written first, the scatter drawn
only where matplotlib imports. The quadrant split and the alignment stay
numpy on the host, as in the JAX package.

An eigenvector's sign is arbitrary (LAPACK, cuSOLVER and XLA may each
pick either), so a PC's projections may be negated between packages or
devices, and the quadrant labels follow the pretrained PCs' signs.
Eigenvalues are ordered by a stable descending ``argsort``.

Usage:
  python -m visreps_tpu_torch.experiments.representation_analysis.two_pcs_compare \
      --features_pre pre.npz --features_trained trained.npz --n_classes 4 \
      --out_dir DIR [--device cpu]
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np
import torch

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.device import input_device, resolve_device
from visreps_tpu_torch.experiments.neurips_2025.figutils import draw_or_report
from visreps_tpu_torch.experiments.representation_analysis.utils import (
    extract_pooled_layers,
    load_feature_npz,
    load_models_pair,
)

PROG = "representation_analysis.two_pcs_compare"
SCRIPT_DIR = str(Path(__file__).resolve().parent)
LAYERS = ["conv4", "fc1", "fc2"]
LAYER_LABELS = {"conv4": "Conv4", "fc1": "FC1", "fc2": "FC2"}


def compute_pca(features, n_pcs: int = 2, device=None):
    """(projections (n, n_pcs), % variance (n_pcs,)) as float32 arrays, by
    an f32 ``eigh`` of the covariance on the device."""
    device = resolve_device(input_device(features, device))
    x = torch.as_tensor(features).to(device, torch.float32)
    centered = x - x.mean(dim=0)
    cov = centered.T @ centered / (x.shape[0] - 1)
    eigval, eigvec = torch.linalg.eigh(cov)
    idx = torch.argsort(eigval, descending=True, stable=True)[:n_pcs]
    var_explained = eigval[idx] / eigval.sum() * 100.0
    return (centered @ eigvec[:, idx]).cpu().numpy(), var_explained.cpu().numpy()


def assign_quadrants(pc1: np.ndarray, pc2: np.ndarray):
    """4 quadrant classes via median splits (numpy)."""
    pc1_med, pc2_med = np.median(pc1), np.median(pc2)
    q = np.zeros(len(pc1), dtype=int)
    q[(pc1 <= pc1_med) & (pc2 > pc2_med)] = 1
    q[(pc1 > pc1_med) & (pc2 <= pc2_med)] = 2
    q[(pc1 > pc1_med) & (pc2 > pc2_med)] = 3
    return q, pc1_med, pc2_med


def align_pcs(trained_pcs: np.ndarray, trained_var: np.ndarray,
              quadrants: np.ndarray):
    """Resolve PCA sign/order ambiguity against the pretrained quadrant
    layout (Q0 lower-left ... Q3 upper-right): score all 8 swap x sign
    configurations by centroid agreement (numpy)."""
    expected = np.array([[-1, -1], [-1, 1], [1, -1], [1, 1]], float)
    centroids = np.stack([trained_pcs[quadrants == q].mean(axis=0) for q in range(4)])

    best, best_cfg = -np.inf, (False, 1, 1)
    for swap in (False, True):
        for s1 in (1, -1):
            for s2 in (1, -1):
                c = centroids[:, [1, 0]] if swap else centroids.copy()
                c = c * np.array([s1, s2], float)
                score = float((c * expected).sum())
                if score > best:
                    best, best_cfg = score, (swap, s1, s2)

    swap, s1, s2 = best_cfg
    if swap:
        trained_pcs = trained_pcs[:, [1, 0]]
        trained_var = trained_var[[1, 0]]
    trained_pcs = trained_pcs * np.array([s1, s2], float)
    return trained_pcs, trained_var, best_cfg


def run_analysis(feats_pre: dict, feats_trn: dict, n_classes: int,
                 out_path: str, layers=None, device=None) -> dict:
    """Per-layer PCA, quadrant assignment and alignment; saves the npz."""
    layers = list(layers or LAYERS)
    save = {"n_classes": n_classes, "layers": np.array(layers)}
    for layer in layers:
        p_pcs, p_var = compute_pca(feats_pre[layer], device=device)
        t_pcs, t_var = compute_pca(feats_trn[layer], device=device)
        quadrants, m1, m2 = assign_quadrants(p_pcs[:, 0], p_pcs[:, 1])
        t_pcs, t_var, cfg = align_pcs(t_pcs, t_var, quadrants)
        rprint(
            f"  {layer}: pre PC1 {p_var[0]:.1f}% PC2 {p_var[1]:.1f}% | "
            f"trained PC1 {t_var[0]:.1f}% PC2 {t_var[1]:.1f}% | align {cfg}",
            style="info",
        )
        save[f"{layer}_pretrained_pcs"] = p_pcs
        save[f"{layer}_trained_pcs"] = t_pcs
        save[f"{layer}_pretrained_var"] = p_var
        save[f"{layer}_trained_var"] = t_var
        save[f"{layer}_quadrants"] = quadrants
        save[f"{layer}_pretrained_medians"] = np.array([m1, m2])
    np.savez_compressed(out_path, **save)
    rprint(f"Saved analysis data to {out_path}", style="success")
    return save


def plot(data, layer: str, out_path: str):
    """Side-by-side quadrant scatter."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    colors = ["#1b9e77", "#7570b3", "#e6ab02", "#d95f02"]
    quadrants = data[f"{layer}_quadrants"]
    n_classes = int(data["n_classes"])
    fig, axes = plt.subplots(1, 2, figsize=(11, 4.8))
    panels = [
        (axes[0], data[f"{layer}_pretrained_pcs"], data[f"{layer}_pretrained_var"],
         "Pretrained AlexNet (1000-way)", "a"),
        (axes[1], data[f"{layer}_trained_pcs"], data[f"{layer}_trained_var"],
         f"Trained AlexNet ({n_classes}-way)", "b"),
    ]
    for ax, pcs, var, title, panel in panels:
        for q in range(4):
            m = quadrants == q
            ax.scatter(pcs[m, 0], pcs[m, 1], c=colors[q], alpha=0.3, s=2,
                       edgecolors="none", rasterized=True)
        ax.set_xlabel(f"PC 1 ({var[0]:.1f}% var.)")
        ax.set_ylabel(f"PC 2 ({var[1]:.1f}% var.)")
        ax.set_title(title, fontweight="bold")
        ax.text(-0.12, 1.08, panel, transform=ax.transAxes, fontsize=18,
                fontweight="bold", va="top")
        ax.spines["top"].set_visible(False)
        ax.spines["right"].set_visible(False)
    fig.suptitle(LAYER_LABELS.get(layer, layer), fontweight="bold")
    plt.tight_layout()
    plt.savefig(out_path, dpi=300, bbox_inches="tight", facecolor="white")
    plt.close(fig)
    rprint(f"Saved figure to {out_path}", style="success")


def main(argv=None):
    """Returns the saved analysis data."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--n_classes", type=int, default=4)
    parser.add_argument("--seed", type=int, default=1, choices=[1, 2, 3])
    parser.add_argument("--checkpoint_dir", default=None)
    parser.add_argument("--dataset", default="imagenet-mini-50")
    parser.add_argument("--features_pre", help="npz of precomputed pretrained features")
    parser.add_argument("--features_trained", help="npz of precomputed trained features")
    parser.add_argument("--layer", default="fc2", choices=LAYERS,
                        help="layer to plot")
    parser.add_argument("--out_dir", default=SCRIPT_DIR)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    if args.features_pre and args.features_trained:
        feats_pre, _ = load_feature_npz(args.features_pre)
        feats_trn, _ = load_feature_npz(args.features_trained)
    else:
        from visreps_tpu_torch.data.obj_cls import get_obj_cls_loader

        pre_model, trn_model = load_models_pair(
            args.n_classes, args.seed, args.checkpoint_dir, device=device)
        _, loaders = get_obj_cls_loader(
            {"dataset": args.dataset, "batchsize": 256, "num_workers": 8,
             "data_augment": False, "pca_labels_folder": "N/A"},
            shuffle=False, train_test_split=False)
        feats_pre, _ = extract_pooled_layers(pre_model, loaders["all"], LAYERS, device=device)
        feats_trn, _ = extract_pooled_layers(trn_model, loaders["all"], LAYERS, device=device)

    data_path = os.path.join(args.out_dir, f"data_{args.n_classes}way.npz")
    data = run_analysis(feats_pre, feats_trn, args.n_classes, data_path, device=device)
    fig_path = os.path.join(
        args.out_dir,
        f"pc_quadrant_pretrained_vs_{args.n_classes}way_{args.layer}.png")
    draw_or_report(PROG, fig_path, plot, data, args.layer, fig_path)
    return data


if __name__ == "__main__":
    main()
