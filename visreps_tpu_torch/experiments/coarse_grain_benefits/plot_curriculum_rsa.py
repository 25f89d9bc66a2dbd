"""Curriculum RSA comparison figure, two panels (port of
``experiments/coarse_grain_benefits/plot_curriculum_rsa.py``).

RSA score against normalised layer depth for the 1K-scratch, 64-way
coarse and 64→1K curriculum AlexNets, one panel per region (EVC / VVS),
from a CSV with ``model_name``, ``region``, ``depth_normalized`` and
``rsa_score`` columns. The per-model series are written as JSON beside
the figure, which is drawn where matplotlib imports.

Usage:
  python -m visreps_tpu_torch.experiments.coarse_grain_benefits.plot_curriculum_rsa \\
      --input results/curriculum_nsd_rsa.csv --out results/curriculum_rsa_comparison.png
"""
from __future__ import annotations

import argparse
import csv
import os
from collections import defaultdict

import numpy as np

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.experiments.neurips_2025.figutils import draw_or_report, write_series

MODEL_NAMES = [
    "AlexNet (1K classes)",
    "AlexNet (64 classes)",
    "AlexNet (64→1K curriculum)",
]
REGIONS = ["early visual stream", "ventral visual stream"]
COLORS = dict(zip(MODEL_NAMES, ["#0072B2", "#2E8B57", "#D55E00"]))
MARKERS = dict(zip(MODEL_NAMES, ["o", "o", "D"]))
LINESTYLES = dict(zip(MODEL_NAMES, ["-", "--", "-."]))
MM = 0.0393701

NATURE_RC = {
    "font.family": "sans-serif",
    "font.size": 7, "axes.titlesize": 8, "axes.labelsize": 7,
    "xtick.labelsize": 6, "ytick.labelsize": 6, "legend.fontsize": 6,
    "lines.linewidth": 1.5, "lines.markersize": 4, "axes.linewidth": 0.5,
    "axes.spines.top": False, "axes.spines.right": False,
    "savefig.bbox": "tight", "savefig.pad_inches": 0.02,
}


def _mean_by_depth(rows, model_name, region):
    """(sorted depths, mean score at each) of one model in one region."""
    acc = defaultdict(list)
    for r in rows:
        if r["model_name"] == model_name and r["region"] == region:
            acc[float(r["depth_normalized"])].append(float(r["rsa_score"]))
    depths = np.array(sorted(acc))
    return depths, np.array([np.mean(acc[d]) for d in depths])


def curves(rows) -> dict:
    """{region: {model: (depths, means)}} of the models with data."""
    out = {}
    for region in REGIONS:
        out[region] = {}
        for name in MODEL_NAMES:
            depths, means = _mean_by_depth(rows, name, region)
            if depths.size:
                out[region][name] = (depths, means)
    return out


def plot_region(ax, rows, region, ylabel=True):
    lines, labels = [], []
    for name in MODEL_NAMES:
        depths, means = _mean_by_depth(rows, name, region)
        if depths.size == 0:
            rprint(f"Warning: no data for {name} in {region}", style="warning")
            continue
        (line,) = ax.plot(depths, means, color=COLORS[name],
                          marker=MARKERS[name], linestyle=LINESTYLES[name],
                          markerfacecolor=COLORS[name], markeredgecolor="white",
                          markeredgewidth=0.4, zorder=3)
        lines.append(line)
        labels.append(name)
    ax.set_xlabel("Normalized depth")
    if ylabel:
        ax.set_ylabel("RSA score")
    ax.set_xlim(-0.05, 1.05)
    ax.set_ylim(0, None)
    ax.set_title("Early Visual" if "early" in region.lower() else "Ventral Visual",
                 fontweight="bold", pad=4)
    return lines, labels


def render(rows, out_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with plt.rc_context(NATURE_RC):
        fig, axes = plt.subplots(1, 2, figsize=(183 * MM, 70 * MM))
        plt.subplots_adjust(wspace=0.2, left=0.07, right=0.72, top=0.88,
                            bottom=0.18)
        l1, lab1 = plot_region(axes[0], rows, REGIONS[0], True)
        l2, lab2 = plot_region(axes[1], rows, REGIONS[1], False)
        seen, all_lines, all_labels = set(), [], []
        for lines, labels in ((l1, lab1), (l2, lab2)):
            for line, label in zip(lines, labels):
                if label not in seen:
                    all_lines.append(line), all_labels.append(label)
                    seen.add(label)
        fig.legend(all_lines, all_labels, loc="center right",
                   bbox_to_anchor=(0.98, 0.5), frameon=True, framealpha=0.95)
        for i, ax in enumerate(axes):
            ax.text(-0.15, 1.08, chr(97 + i), transform=ax.transAxes,
                    fontsize=10, fontweight="bold", va="top")
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fig.savefig(out_path, dpi=300)
        plt.close(fig)
    rprint(f"Saved: {out_path}", style="success")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--input", default="experiments/coarse_grain_benefits/results/curriculum_nsd_rsa.csv")
    parser.add_argument(
        "--out", default="experiments/coarse_grain_benefits/results/curriculum_rsa_comparison.png")
    args = parser.parse_args(argv)
    with open(args.input) as f:
        rows = list(csv.DictReader(f))
    series = curves(rows)
    write_series(args.out, series)
    draw_or_report("plot_curriculum_rsa", args.out, render, rows, args.out)
    return series


if __name__ == "__main__":
    main()
