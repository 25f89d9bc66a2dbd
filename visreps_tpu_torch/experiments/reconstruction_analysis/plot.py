"""Reconstruction-analysis figures: RSA vs pca_k with baselines (port of
``experiments/reconstruction_analysis/plot.py``).

From results.db (``sqlite3``, no pandas): the best-layer RSA score of
the 1000-way ``reconstruct_from_pcs`` runs against the number of
retained PCs, with two horizontal baselines — the unreconstructed
1000-way model and the best coarse-grained model over every label
source. pandas' ``groupby(...).idxmax()`` (the first maximum wins),
means and SEMs are redone by ``figutils``' groupby helpers. One figure
per neural dataset, NSD (1 × 2 regions), TVSD (1 × 3) and THINGS (one
panel), drawn where matplotlib imports; each figure's series are
written as JSON beside it either way.

Usage:
  python -m visreps_tpu_torch.experiments.reconstruction_analysis.plot --db results.db
"""
from __future__ import annotations

import argparse
import sqlite3
from pathlib import Path

import numpy as np

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.experiments.neurips_2025.figutils import (
    Table,
    draw_or_report,
    from_records,
    group_agg,
    group_count,
    group_idxmax,
    nanmean,
    nanstd,
    write_series,
)

FIGURES_DIR = Path(__file__).resolve().parent / "figures"
CURVE_COLOR, TRAINED_COLOR, COARSE_COLOR = "#1f77b4", "#2ca02c", "#d62728"
DATASETS = [
    ("nsd", [("early visual stream", "Early Visual Stream"),
             ("ventral visual stream", "Ventral Visual Stream")], (8, 3.5)),
    ("tvsd", [("V1", "V1"), ("V4", "V4"), ("IT", "IT")], (11, 3.5)),
    ("things-behavior", [("N/A", "THINGS Behavior")], (4.5, 3.5)),
]


def _read(db_path, query, params) -> Table:
    conn = sqlite3.connect(str(db_path))
    try:
        cur = conn.execute(query, params)
        names = [d[0] for d in cur.description]
        return from_records(cur.fetchall(), names)
    finally:
        conn.close()


def _where_region(q: str, params: list, region) -> str:
    if region is not None:
        q += " AND region = ?"
        params.append(region)
    return q


def query_reconstruction_curve(db_path, neural_dataset, region=None) -> Table:
    """Best-layer score per (pca_k, seed, subject) for reconstruction runs."""
    params = [neural_dataset]
    q = _where_region("""SELECT pca_k, seed, subject_idx, layer, score FROM results
           WHERE reconstruct_from_pcs = 1 AND cfg_id = 1000
             AND analysis = 'rsa' AND compare_method = 'spearman'
             AND neural_dataset = ?""", params, region)
    df = _read(db_path, q, params)
    if df.empty:
        return df
    return df.take(group_idxmax(df, ["pca_k", "seed", "subject_idx"]))


def query_1000way_baseline(db_path, neural_dataset, region=None):
    """(mean, sem) of the unreconstructed 1000-way model across seeds."""
    params = [neural_dataset]
    q = _where_region("""SELECT seed, subject_idx, layer, score FROM results
           WHERE cfg_id = 1000 AND reconstruct_from_pcs = 0
             AND analysis = 'rsa' AND compare_method = 'spearman'
             AND neural_dataset = ?""", params, region)
    df = _read(db_path, q, params)
    if df.empty:
        return np.nan, np.nan
    best = df.take(group_idxmax(df, ["seed", "subject_idx"]))
    seed_means = group_agg(best, "seed")["score"]
    sem = nanstd(seed_means) / np.sqrt(len(seed_means)) if len(seed_means) > 1 else 0.0
    return float(nanmean(seed_means)), float(sem)


def query_coarse_baseline(db_path, neural_dataset, region=None):
    """(mean, sem) of the best coarse model over all label sources."""
    params = [neural_dataset]
    q = _where_region("""SELECT checkpoint_dir, cfg_id, seed, subject_idx, layer, score
           FROM results
           WHERE reconstruct_from_pcs = 0 AND pca_labels = 1
             AND cfg_id IN (2, 4, 8, 16, 32, 64)
             AND analysis = 'rsa' AND compare_method = 'spearman'
             AND neural_dataset = ?""", params, region)
    df = _read(db_path, q, params)
    if df.empty:
        return np.nan, np.nan
    best = df.take(group_idxmax(df, ["checkpoint_dir", "cfg_id", "seed", "subject_idx"]))
    seed_means = group_agg(best, ["checkpoint_dir", "cfg_id", "seed"])
    grand = group_agg(seed_means, ["checkpoint_dir", "cfg_id"], aggs=(
        ("mean", nanmean), ("std", nanstd), ("count", group_count)))
    sem = grand["std"] / np.sqrt(grand["count"])
    row = int(np.nanargmax(grand["mean"]))
    return float(grand["mean"][row]), float(0.0 if np.isnan(sem[row]) else sem[row])


def aggregate_curve(df: Table) -> Table:
    """mean ± SEM across seeds, subjects averaged within seed first."""
    if df.empty:
        return Table({"pca_k": np.zeros(0), "mean": np.zeros(0), "sem": np.zeros(0)})
    seed_means = group_agg(df, ["pca_k", "seed"])
    agg = group_agg(seed_means, "pca_k", aggs=(
        ("mean", nanmean), ("std", nanstd), ("count", group_count)))
    sem = agg["std"] / np.sqrt(agg["count"])
    return Table({"pca_k": agg["pca_k"], "mean": agg["mean"],
                  "sem": np.where(np.isnan(sem), 0.0, sem)})


def dataset_series(db_path, neural_dataset, regions) -> dict:
    """{region: {"curve": aggregate_curve, "trained": (mean, sem),
    "coarse": (mean, sem)}} of one dataset's panels."""
    out = {}
    for region, _ in regions:
        out[region] = {
            "curve": aggregate_curve(query_reconstruction_curve(db_path, neural_dataset, region)),
            "trained": query_1000way_baseline(db_path, neural_dataset, region),
            "coarse": query_coarse_baseline(db_path, neural_dataset, region),
        }
    return out


def plot_panel(ax, curve, trained, coarse, title, show_ylabel=True):
    from matplotlib.ticker import MaxNLocator

    k, mean, sem = curve["pca_k"], curve["mean"], curve["sem"]
    ax.plot(k, mean, "-o", color=CURVE_COLOR, markersize=4, linewidth=1.5,
            label="1000-way (top-$k$ PCs)", zorder=3)
    ax.fill_between(k, mean - sem, mean + sem, color=CURVE_COLOR, alpha=0.15)
    t_mean, t_sem = trained
    if not np.isnan(t_mean):
        ax.axhline(t_mean, color=TRAINED_COLOR, linewidth=1.5,
                   label="1000-way (all dims)", zorder=1)
        if t_sem > 0:
            ax.axhspan(t_mean - t_sem, t_mean + t_sem, color=TRAINED_COLOR,
                       alpha=0.10, zorder=0)
    c_mean, c_sem = coarse
    if not np.isnan(c_mean):
        ax.axhline(c_mean, color=COARSE_COLOR, linestyle="--", linewidth=1.5,
                   label="Best coarse model", zorder=1)
        if c_sem > 0:
            ax.axhspan(c_mean - c_sem, c_mean + c_sem, color=COARSE_COLOR,
                       alpha=0.10, zorder=0)
    ax.set_xlabel("Number of PCs ($k$)")
    if show_ylabel:
        ax.set_ylabel("RSA Score (Spearman)")
    ax.set_title(title, fontweight="bold")
    ax.xaxis.set_major_locator(MaxNLocator(integer=True))


def draw_dataset(series: dict, regions, figsize, out_path):
    """One dataset's figure from ``dataset_series``' output."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, len(regions), figsize=figsize, squeeze=False)
    axes = axes.flatten()
    for i, (region, label) in enumerate(regions):
        panel = series[region]
        if panel["curve"].empty:
            axes[i].text(0.5, 0.5, "No data", ha="center", va="center",
                         transform=axes[i].transAxes)
            axes[i].set_title(label, fontweight="bold")
            continue
        plot_panel(axes[i], panel["curve"], panel["trained"], panel["coarse"],
                   label, show_ylabel=(i == 0))
    handles, labels = axes[0].get_legend_handles_labels()
    if handles:
        fig.legend(handles, labels, loc="lower center", ncol=3,
                   bbox_to_anchor=(0.5, -0.02), frameon=True)
    for ax in axes:
        ax.spines["top"].set_visible(False)
        ax.spines["right"].set_visible(False)
    plt.tight_layout(rect=[0, 0.06, 1, 1])
    plt.savefig(out_path, dpi=300, bbox_inches="tight", facecolor="white")
    plt.close(fig)
    rprint(f"Saved: {out_path}", style="success")


def plot_dataset(db_path, neural_dataset, regions, figsize, out_dir=None) -> dict:
    """One dataset's series (written as JSON) and its figure where
    matplotlib imports; returns the series."""
    out_dir = Path(out_dir or FIGURES_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = str(out_dir / f"reconstruction_{neural_dataset}.png")
    series = dataset_series(db_path, neural_dataset, regions)
    write_series(out_path, series)
    draw_or_report("reconstruction_analysis.plot", out_path, draw_dataset, series, regions,
                   figsize, out_path)
    return series


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--db", default="results.db")
    parser.add_argument("--out_dir", default=None)
    args = parser.parse_args(argv)
    return {name: plot_dataset(args.db, name, regions, figsize, args.out_dir)
            for name, regions, figsize in DATASETS}


if __name__ == "__main__":
    main()
