"""Fig. 1b, inter-seed vs cross-model RSM agreement per layer (port of
``experiments/neurips_2025/fig1/model_reps_rsa_comparisons.py``).

Four RSM npz files (1K-reconstructed seeds 1/2, coarse-trained seeds
1/2) → per-layer RSM correlations of the three pairings (F1–F2 and T1–T2
inter-seed, F1–T1 cross) by ``ops/rdm.compute_rdm_correlation`` on the
device (Kendall by default: the port's tau-a). The scores are written as
JSON beside the grouped-bar figure, which is drawn where matplotlib
imports.

Usage:
  python -m visreps_tpu_torch.experiments.neurips_2025.fig1.model_reps_rsa_comparisons \\
      --n_pca_cls 4 --base_rsm_dir model_checkpoints/RSMs [--device cpu]
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np
import torch

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.device import resolve_device
from visreps_tpu_torch.experiments.neurips_2025.figutils import draw_or_report, write_series
from visreps_tpu_torch.ops.rdm import compute_rdm_correlation


def load_rsms(path):
    """{layer: (n, n) array} from an npz, or None when it is missing."""
    try:
        data = np.load(path, allow_pickle=True)
        return {k: data[k] for k in data.files}
    except FileNotFoundError:
        rprint(f"Error: file not found at {path}", style="error")
        return None


def rsm_correlation(a: np.ndarray, b: np.ndarray, method: str, device=None) -> float:
    device = resolve_device(device)
    return float(compute_rdm_correlation(
        torch.as_tensor(np.asarray(a, np.float32), device=device),
        torch.as_tensor(np.asarray(b, np.float32), device=device), method))


def compare_layers(rsms_f1, rsms_f2, rsms_t1, rsms_t2, method: str, device=None):
    """(layers, f1f2, t1t2, f1t1) per-layer scores."""
    common = (set(rsms_f1) & set(rsms_f2) & set(rsms_t1) & set(rsms_t2)) - {"neural"}
    layers = sorted(common)
    f1f2 = [rsm_correlation(rsms_f1[l], rsms_f2[l], method, device) for l in layers]
    t1t2 = [rsm_correlation(rsms_t1[l], rsms_t2[l], method, device) for l in layers]
    f1t1 = [rsm_correlation(rsms_f1[l], rsms_t1[l], method, device) for l in layers]
    return layers, f1f2, t1t2, f1t1


def plot_grouped(layers, f1f2, t1t2, f1t1, n_pca_cls, method, out):
    """Grouped bars: silver/dimgray inter-seed + red cross."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x = np.arange(len(layers))
    w = 0.25
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.bar(x - w, f1f2, w, label="Inter-seed (1K rec.)", color="silver")
    ax.bar(x, t1t2, w, label=f"Inter-seed ({n_pca_cls} CLS)", color="dimgray")
    ax.bar(x + w, f1t1, w, label=f"1K rec. vs {n_pca_cls} CLS", color="#FF6B6B")
    ax.set_xticks(x)
    ax.set_xticklabels(layers, rotation=45, ha="right")
    ax.set_ylabel(f"RSM correlation ({method})")
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    ax.legend(frameon=True, facecolor="white")
    plt.tight_layout()
    plt.savefig(out, dpi=300, bbox_inches="tight")
    plt.close(fig)
    rprint(f"Saved {out}", style="success")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--n_pca_cls", type=int, default=4)
    parser.add_argument("--correlation_method", default="Kendall",
                        choices=["Pearson", "Spearman", "Kendall"])
    parser.add_argument("--output_dir", default="plotters/fig1")
    parser.add_argument("--base_rsm_dir", default="model_checkpoints/RSMs")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    n_pcs = int(np.log2(args.n_pca_cls)) if args.n_pca_cls > 0 else 0
    base = Path(args.base_rsm_dir) / f"pca{args.n_pca_cls}cls"
    paths = {
        "f1": base / f"rsms_nsd_pca_labels_False_pca_k_{n_pcs}_cfgid_1_seed_1.npz",
        "f2": base / f"rsms_nsd_pca_labels_False_pca_k_{n_pcs}_cfgid_1_seed_2.npz",
        "t1": base / f"rsms_nsd_pca_labels_True_cfgid_{n_pcs}_seed_1.npz",
        "t2": base / f"rsms_nsd_pca_labels_True_cfgid_{n_pcs}_seed_2.npz",
    }
    rsms = {k: load_rsms(p) for k, p in paths.items()}
    missing = [str(paths[k]) for k, v in rsms.items() if v is None]
    if missing:
        rprint(f"Missing RSM files: {missing}", style="error")
        return None
    layers, f1f2, t1t2, f1t1 = compare_layers(
        rsms["f1"], rsms["f2"], rsms["t1"], rsms["t2"], args.correlation_method, device)
    if not layers:
        rprint("No common layers across RSM files.", style="error")
        return None
    os.makedirs(args.output_dir, exist_ok=True)
    out = os.path.join(args.output_dir,
                       f"rsa_grouped_{args.n_pca_cls}cls_{args.correlation_method.lower()}.png")
    series = {"layers": layers, "f1f2": f1f2, "t1t2": t1t2, "f1t1": f1t1}
    write_series(out, series)
    draw_or_report("fig1.model_reps_rsa_comparisons", out, plot_grouped, layers, f1f2, t1t2,
                   f1t1, args.n_pca_cls, args.correlation_method, out)
    return series


if __name__ == "__main__":
    main()
