"""Fig. 1a schematic: a synthetic ImageNet manifold split at PCA medians
(port of ``experiments/neurips_2025/fig1/imagenet_pca_schematic.py``).

50 Gaussian proxy classes on a tilted 2-D ellipse embedded in 50-D
(numpy ``default_rng(7)``, so the points equal the JAX program's),
z-scored and PCA'd back to 2-D by numpy's SVD, drawn three ways — (a) the
classes, (b) the PC1 median split into 2 classes, (c) the PC1/PC2
quadrants as 4 classes. The 2-D points, labels, medians and quadrant
sizes are written as an npz beside the figure, which is drawn only where
matplotlib imports.

Usage:
  python -m visreps_tpu_torch.experiments.neurips_2025.fig1.imagenet_pca_schematic \\
      [--out plotters/neurips/fig1/schematic_imagenet_pca.png]
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.experiments.neurips_2025.figutils import draw_or_report

PROG = "fig1.imagenet_pca_schematic"

SEED = 7
N_POINTS, D, N_CLASSES = 10_000, 50, 50
ELLIPSE_A, ELLIPSE_B = 4.0, 6.0
SIGMA_CLUSTER = 0.50
TILT = np.pi / 6
CBLUE, CVERMIL, CGREEN, CMAG = "#0072B2", "#D55E00", "#009E73", "#CC79A7"


def random_orthonormal(d, k, rng):
    q, _ = np.linalg.qr(rng.normal(size=(d, k)))
    return q[:, :k]


def make_synthetic(seed=SEED, n_points=N_POINTS, n_classes=N_CLASSES, d=D):
    """(X in R^d, labels): elliptic cluster layout embedded + rotated."""
    rng = np.random.default_rng(seed)
    u2 = random_orthonormal(d, 2, rng)
    cents = []
    for _ in range(n_classes):
        r, th = np.sqrt(rng.uniform(0, 1)), rng.uniform(0, 2 * np.pi)
        cents.append([ELLIPSE_A * r * np.cos(th), ELLIPSE_B * r * np.sin(th)])
    rot = np.array([[np.cos(TILT), -np.sin(TILT)], [np.sin(TILT), np.cos(TILT)]])
    cents = np.asarray(cents) @ rot.T
    per = n_points // n_classes
    xs, ys = [], []
    for k in range(n_classes):
        pts2 = cents[k] + rng.normal(scale=SIGMA_CLUSTER, size=(per, 2))
        xs.append(pts2 @ u2.T + rng.normal(scale=0.02, size=(per, d)))
        ys.append(np.full(per, k, np.int32))
    x = np.vstack(xs) @ random_orthonormal(d, d, rng)
    return x, np.concatenate(ys)


def pca_2d(x):
    """Z-scored 2-component PCA via SVD."""
    z = (x - x.mean(0)) / np.maximum(x.std(0), 1e-8)
    _, _, vt = np.linalg.svd(z - z.mean(0), full_matrices=False)
    return (z - z.mean(0)) @ vt[:2].T


def schematic_data(seed=SEED) -> dict:
    """The points the figure draws: 2-D PCA coordinates, class labels,
    the two medians and the quadrant of each point (0–3 as drawn in c)."""
    x, y = make_synthetic(seed)
    x2 = pca_2d(x)
    med = np.array([np.median(x2[:, 0]), np.median(x2[:, 1])])
    quadrant = (x2[:, 0] >= med[0]).astype(np.int64) + 2 * (x2[:, 1] >= med[1])
    return {"points": x2, "labels": y, "medians": med, "quadrant": quadrant}


def _palette(n, plt):
    import matplotlib as mpl

    cols = np.vstack([plt.cm.tab20(np.linspace(0, 1, 20)),
                      plt.cm.tab20b(np.linspace(0, 1, 20)),
                      plt.cm.tab20c(np.linspace(0, 1, 20))])
    hexes = [mpl.colors.rgb2hex(c[:3]) for c in cols]
    return [hexes[i % len(hexes)] for i in range(n)]


def render(data: dict, out_png: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x2, y = data["points"], data["labels"]
    pc1, pc2 = x2[:, 0], x2[:, 1]
    med1, med2 = data["medians"]

    fig, axes = plt.subplots(1, 3, figsize=(7.2, 2.6), dpi=300,
                             constrained_layout=True)

    def strip(ax):
        ax.set_xticks([]), ax.set_yticks([])
        for sp in ax.spines.values():
            sp.set_visible(False)

    def title(ax, bold):
        ax.text(0.5, 1.03, "ImageNet ", transform=ax.transAxes, ha="right",
                va="bottom", fontsize=9.5)
        ax.text(0.5, 1.03, bold, transform=ax.transAxes, ha="left",
                va="bottom", fontsize=9.5, weight="bold")

    cols = _palette(N_CLASSES, plt)
    for k in range(N_CLASSES):
        m = y == k
        axes[0].scatter(x2[m, 0], x2[m, 1], s=4, alpha=0.8, c=[cols[k]],
                        edgecolors="none", rasterized=True)
    strip(axes[0]), title(axes[0], "1K Classes")

    m = pc1 >= med1
    axes[1].scatter(x2[~m, 0], x2[~m, 1], s=4, alpha=0.8, c=CBLUE,
                    edgecolors="none", rasterized=True)
    axes[1].scatter(x2[m, 0], x2[m, 1], s=4, alpha=0.8, c=CVERMIL,
                    edgecolors="none", rasterized=True)
    strip(axes[1]), title(axes[1], "2 Classes")
    xmin, xmax = pc1.min(), pc1.max()
    lx, cx = 0.42 * (xmax - xmin), (xmin + xmax) / 2
    axes[1].annotate("", xy=(cx + lx, med2), xytext=(cx - lx, med2),
                     arrowprops=dict(arrowstyle="<->", lw=1.8, color="black"))
    axes[1].text(cx + lx * 1.05, med2, "PC1", fontsize=9, weight="bold",
                 va="center", ha="left")

    quads = [(pc1 < med1) & (pc2 < med2), (pc1 >= med1) & (pc2 < med2),
             (pc1 < med1) & (pc2 >= med2), (pc1 >= med1) & (pc2 >= med2)]
    for msk, c in zip(quads, [CBLUE, CVERMIL, CGREEN, CMAG]):
        axes[2].scatter(x2[msk, 0], x2[msk, 1], s=4, alpha=0.8, c=c,
                        edgecolors="none", rasterized=True)
    strip(axes[2]), title(axes[2], "4 Classes")
    ymin, ymax = pc2.min(), pc2.max()
    ly = 0.42 * (ymax - ymin)
    axes[2].annotate("", xy=(med1 + lx, med2), xytext=(med1 - lx, med2),
                     arrowprops=dict(arrowstyle="<->", lw=1.6, color="black"))
    axes[2].annotate("", xy=(med1, med2 + ly), xytext=(med1, med2 - ly),
                     arrowprops=dict(arrowstyle="<->", lw=1.6, color="black"))
    axes[2].text(med1 + lx * 1.05, med2, "PC1", fontsize=8.5, weight="bold",
                 va="center", ha="left")
    axes[2].text(med1, med2 + ly * 1.05, "PC2", fontsize=8.5, weight="bold",
                 va="bottom", ha="center")

    for i, ax in enumerate(axes):
        ax.text(0.01, 0.98, chr(ord("a") + i), transform=ax.transAxes,
                va="top", ha="left", fontsize=10, fontweight="bold")

    os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
    fig.savefig(out_png, bbox_inches="tight")
    plt.close(fig)
    rprint(f"Saved {out_png}", style="success")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="plotters/neurips/fig1/schematic_imagenet_pca.png")
    args = parser.parse_args(argv)
    data = schematic_data()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez(Path(args.out).with_suffix(".npz"), **data)
    draw_or_report(PROG, args.out, render, data, args.out)
    return data


if __name__ == "__main__":
    main()
