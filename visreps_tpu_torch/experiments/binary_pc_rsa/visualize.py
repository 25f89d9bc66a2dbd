"""Binary-PC RSA scores against AlexNet baselines (port of
``experiments/binary_pc_rsa/visualize.py``).

Per region (early / ventral): the subject-averaged RSA score of the
weighted and unweighted Hamming RDMs against the number of binarised
PCs (Spearman and Kendall panels), with the untrained / trained AlexNet
layer baselines as dashed lines. The series are written as JSON beside
each figure, which is drawn where matplotlib imports.

Usage:
  python -m visreps_tpu_torch.experiments.binary_pc_rsa.visualize \\
      --results experiments/binary_pc_rsa/binary_pc_rsa.csv --out_dir experiments/binary_pc_rsa
"""
from __future__ import annotations

import argparse
import csv
import os
from collections import defaultdict

import numpy as np

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.experiments.neurips_2025.figutils import draw_or_report, write_series

LAYER_FOR_REGION = {
    "early visual stream": "conv4",
    "ventral visual stream": "fc1",
}
REGIONS = list(LAYER_FOR_REGION)
CORRELATIONS = ["Spearman", "Kendall"]
COLORS = {"Weighted": "#E63946", "Non-weighted": "#F4A261"}


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def load_baselines(cnn_csv: str, subjects) -> dict:
    """(region, correlation, epoch) -> mean score of the mapped layer."""
    rows = _read_csv(cnn_csv)
    acc = defaultdict(list)
    for r in rows:
        corr = r.get("correlation") or r.get("compare_rsm_correlation")
        if r.get("subject_idx") not in subjects:
            continue
        region = r.get("region")
        if LAYER_FOR_REGION.get(region) != r.get("layer"):
            continue
        acc[(region, corr, int(r["epoch"]))].append(float(r["score"]))
    return {k: float(np.mean(v)) for k, v in acc.items()}


def average_over_subjects(rows) -> dict:
    """(n_pcs, region, weighted, correlation) -> mean score."""
    acc = defaultdict(list)
    for r in rows:
        key = (int(r["n_pcs"]), r["region"],
               str(r["weighted"]).lower() in ("true", "1"), r["correlation"])
        acc[key].append(float(r["score"]))
    return {k: float(np.mean(v)) for k, v in acc.items()}


def region_series(region, avg, baseline) -> dict:
    """One region's plotted series: per correlation, each curve's
    (n_pcs, score) points and the baselines by epoch."""
    out = {}
    for corr in CORRELATIONS:
        curves = {label: sorted((k[0], v) for k, v in avg.items()
                                if k[1] == region and k[2] == weighted and k[3] == corr)
                  for weighted, label in ((True, "Weighted"), (False, "Non-weighted"))}
        out[corr] = {"curves": curves,
                     "baselines": {e: baseline.get((region, corr, e)) for e in (0, 20)}}
    return out


def plot_region(region, avg, baseline, out_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(10, 4), sharex=True, sharey=True)
    layer = LAYER_FOR_REGION[region]
    for col, corr in enumerate(CORRELATIONS):
        ax = axes[col]
        for epoch, color, label in ((0, "#808080", "untrained"),
                                    (20, "#457B9D", "trained")):
            score = baseline.get((region, corr, epoch))
            if score is not None:
                ax.axhline(score, color=color, linestyle="--", linewidth=2,
                           label=f"AlexNet {layer} ({label})", zorder=1)
        for weighted, label in ((True, "Weighted"), (False, "Non-weighted")):
            pts = sorted(
                (k[0], v) for k, v in avg.items()
                if k[1] == region and k[2] == weighted and k[3] == corr)
            if pts:
                xs, ys = zip(*pts)
                ax.plot(xs, ys, marker="o", markersize=4, linewidth=2,
                        color=COLORS[label], label=label, zorder=2)
        ax.set_title(corr, fontweight="bold")
        ax.set_ylabel("RSA Score" if col == 0 else "")
        ax.set_xlabel("Number of PCs")
        ax.grid(True, alpha=0.3)
        ax.set_xticks([5, 10, 15, 20])
        ax.set_xticks(np.arange(2, 21, 1), minor=True)
        ax.set_xlim(1.5, 20.5)

    plt.suptitle(f"Binary PC RSA: {region.title()} (averaged across subjects)",
                 fontweight="bold")
    handles, labels = axes[0].get_legend_handles_labels()
    fig.legend(handles, labels, loc="center left", bbox_to_anchor=(1.0, 0.5),
               fontsize=9, frameon=True)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    plt.tight_layout()
    plt.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    rprint(f"Saved to {out_path}", style="success")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--results", default="experiments/binary_pc_rsa/binary_pc_rsa.csv")
    parser.add_argument("--cnn_baseline", default="logs/binary_pc_exp_CNN.csv")
    parser.add_argument("--out_dir", default="experiments/binary_pc_rsa")
    args = parser.parse_args(argv)

    rows = _read_csv(args.results)
    subjects = {r["subject_idx"] for r in rows}
    baseline = (load_baselines(args.cnn_baseline, subjects)
                if os.path.exists(args.cnn_baseline) else {})
    avg = average_over_subjects(rows)
    series = {}
    for region in REGIONS:
        short = region.replace(" visual stream", "").replace(" ", "_")
        out = os.path.join(args.out_dir, f"binary_pc_rsa_{short}.png")
        series[region] = region_series(region, avg, baseline)
        write_series(out, series[region])
        draw_or_report("binary_pc_rsa.visualize", out, plot_region, region, avg, baseline, out)
    return series


if __name__ == "__main__":
    main()
