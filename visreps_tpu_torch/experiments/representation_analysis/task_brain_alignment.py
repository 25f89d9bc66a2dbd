"""Task–brain alignment: do task-discriminative dimensions predict the
brain? (port of ``experiments/representation_analysis/task_brain_alignment.py``).

Per layer: (1) task importance per feature dimension — the Fisher ratio
over the training-class labels (class sums by ``index_add_`` on the
device) or the variance of class centroids (numpy); (2) brain importance —
the mean |ridge weight| per dimension of an encoding fit to neural
responses (``ops/ridge.ridge_cv`` on the device, seeded 80/20 split,
z-scored with the fit rows' mean and population std); (3) alignment of
the two vectors: cosine, Spearman and Pearson (``ops/stats``) and top-K
overlaps (numpy ``argsort``, as in the JAX package). Appends one row per
run to ``task_brain_alignment.csv``; the figure is drawn only where
matplotlib imports.

Usage:
  python -m visreps_tpu_torch.experiments.representation_analysis.task_brain_alignment \\
      --task-features feats.npy --task-labels labels.npy \\
      --brain-features nsd_feats.npy --brain-responses neural.npy \\
      --layer fc2 --out-dir results/ [--device cpu]
"""
from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np
import torch

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.device import input_device, resolve_device
from visreps_tpu_torch.experiments.neurips_2025.figutils import draw_or_report
from visreps_tpu_torch.ops.ridge import correlation_score, ridge_cv
from visreps_tpu_torch.ops.stats import pearson_corr, spearman_corr

PROG = "representation_analysis.task_brain_alignment"
SEED = 42


def fisher_discriminant_per_dim(features, labels, n_classes: int, device=None) -> torch.Tensor:
    """Per-dimension Fisher ratio: between-class over within-class
    variance, (d,) float32 on the device. The class counts, sums and sums
    of squares are three ``index_add_`` scatters over the labels."""
    device = resolve_device(input_device(features, device))
    x = torch.as_tensor(features).to(device, torch.float32)
    y = torch.as_tensor(np.asarray(labels) if not isinstance(labels, torch.Tensor) else labels)
    y = y.to(device, torch.long)
    n, d = x.shape
    counts = torch.zeros(n_classes, dtype=torch.float32, device=device).index_add_(
        0, y, torch.ones(n, dtype=torch.float32, device=device))
    sums = torch.zeros((n_classes, d), dtype=torch.float32, device=device).index_add_(0, y, x)
    means = sums / counts[:, None].clamp_min(1.0)
    global_mean = x.mean(dim=0)

    between = (counts[:, None] * (means - global_mean[None, :]) ** 2).sum(dim=0) / n
    sq_sums = torch.zeros((n_classes, d), dtype=torch.float32, device=device).index_add_(
        0, y, x**2)
    within = (sq_sums - counts[:, None] * means**2).sum(dim=0) / n
    return between / (within + 1e-10)


def class_centroid_importance(features: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Variance of the class centroids per dimension (numpy)."""
    classes = np.unique(labels)
    centroids = np.stack([features[labels == c].mean(axis=0) for c in classes])
    return centroids.var(axis=0)


def brain_predictive_weights(features, neural, seed: int = SEED, device=None):
    """(mean |ridge weight| per feature dimension (d,) array, encoding mean
    r on the held-out 20 %, median alpha): ``default_rng(seed)``
    permutation split 80/20, features z-scored with the fit rows' mean and
    ddof-0 std (+1e-8), per-voxel alphas by ``ridge_cv``."""
    device = resolve_device(input_device(features, device))
    n = len(features)
    idx = np.random.default_rng(seed).permutation(n)
    split = int(0.8 * n)
    tr = torch.as_tensor(idx[:split], device=device)
    te = torch.as_tensor(idx[split:], device=device)

    x = torch.as_tensor(features).to(device, torch.float32)
    y = torch.as_tensor(neural).to(device, torch.float32)
    xm = x[tr].mean(dim=0)
    xs = x[tr].std(dim=0, correction=0) + 1e-8
    x_tr = (x[tr] - xm) / xs
    x_te = (x[te] - xm) / xs

    model = ridge_cv(x_tr, y[tr])
    pred = model.predict(x_te)
    mean_r = float(correlation_score(y[te], pred).mean())
    weights = model.weights.abs().mean(dim=1).cpu().numpy()  # (d,)
    alpha_median = float(np.median(model.best_alphas.cpu().numpy()))
    return weights, mean_r, alpha_median


def compute_alignment(task_w: np.ndarray, brain_w: np.ndarray, device=None) -> dict:
    """Cosine (numpy), Spearman and Pearson (float32, on ``device``) of
    the two importance vectors, and their top-K overlaps (numpy)."""
    device = resolve_device(input_device(task_w, device))
    t = task_w / (np.linalg.norm(task_w) + 1e-10)
    b = brain_w / (np.linalg.norm(brain_w) + 1e-10)
    tt = torch.as_tensor(task_w).to(device, torch.float32)
    bt = torch.as_tensor(brain_w).to(device, torch.float32)
    out = {
        "cosine_similarity": float(t @ b),
        "spearman_r": float(spearman_corr(tt, bt)),
        "pearson_r": float(pearson_corr(tt, bt)),
    }
    for k in (100, 500, 1000):
        kk = min(k, len(task_w) // 2) or 1
        top_t = set(np.argsort(task_w)[-kk:].tolist())
        top_b = set(np.argsort(brain_w)[-kk:].tolist())
        out[f"top_{k}_overlap"] = len(top_t & top_b) / kk
    return out


def plot_alignment(task_w, brain_w, metrics, layer, out_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    axes[0].scatter(np.log10(task_w + 1e-10), np.log10(brain_w + 1e-10),
                    s=4, alpha=0.3, color="#4c72b0")
    axes[0].set_xlabel("log10 task importance (Fisher)")
    axes[0].set_ylabel("log10 brain importance (|ridge w|)")
    axes[0].set_title(f"{layer}: spearman r = {metrics['spearman_r']:.3f}")
    order_t = np.argsort(-task_w)
    axes[1].plot(np.cumsum(brain_w[order_t]) / brain_w.sum(), label="by task rank")
    axes[1].plot(np.cumsum(np.sort(brain_w)[::-1]) / brain_w.sum(),
                 label="by brain rank (oracle)", linestyle="--")
    axes[1].set_xlabel("Dimensions (ranked)")
    axes[1].set_ylabel("Cumulative brain importance")
    axes[1].legend()
    plt.tight_layout()
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(out_path, dpi=150)
    plt.close(fig)


def main(argv=None):
    """Returns the CSV row."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--task-features", required=True,
                        help=".npy (n, d) features on labeled images")
    parser.add_argument("--task-labels", required=True, help=".npy class labels")
    parser.add_argument("--brain-features", required=True,
                        help=".npy (m, d) features on NSD stimuli")
    parser.add_argument("--brain-responses", required=True,
                        help=".npy (m, v) neural responses")
    parser.add_argument("--layer", default="fc2")
    parser.add_argument("--task-importance", default="fisher",
                        choices=["fisher", "centroid"])
    parser.add_argument("--out-dir", default="experiments/representation_analysis/results")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    feats = np.load(args.task_features).astype(np.float32)
    labels = np.load(args.task_labels).astype(np.int32)
    if args.task_importance == "fisher":
        task_w = fisher_discriminant_per_dim(
            feats, labels, int(labels.max()) + 1, device=device).cpu().numpy()
    else:
        task_w = class_centroid_importance(feats, labels)

    brain_feats = np.load(args.brain_features).astype(np.float32)
    neural = np.load(args.brain_responses).astype(np.float32)
    brain_w, mean_r, alpha_med = brain_predictive_weights(brain_feats, neural, device=device)

    metrics = compute_alignment(task_w, brain_w, device=device)
    rprint(f"[{args.layer}] encoding mean r={mean_r:.4f}, alpha_med={alpha_med:.2g}",
           style="highlight")
    for k, v in metrics.items():
        rprint(f"  {k}: {v:.4f}", style="info")

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    row = {"layer": args.layer, "encoding_mean_r": mean_r,
           "alpha_median": alpha_med, **metrics}
    csv_path = out_dir / "task_brain_alignment.csv"
    exists = csv_path.exists()
    with open(csv_path, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(row.keys()))
        if not exists:
            writer.writeheader()
        writer.writerow(row)
    draw_or_report(PROG, str(out_dir / f"task_brain_alignment_{args.layer}.png"),
                   plot_alignment, task_w, brain_w, metrics, args.layer,
                   out_dir / f"task_brain_alignment_{args.layer}.png")
    return row


if __name__ == "__main__":
    main()
