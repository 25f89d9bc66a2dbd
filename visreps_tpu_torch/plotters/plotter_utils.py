"""results.db queries and summaries of the figures (port of
``plotters/plotter_utils.py``), on ``sqlite3``, numpy and scipy, without
pandas.

Rows come back as a ``figutils.Table`` typed as pandas'
``read_sql_query`` types them, and the summaries follow pandas' rules:

  * ``query_best_scores`` binds ``cfg_id`` and ``epoch`` as strings,
    excludes PC-reconstruction rows, prints a warning for each duplicated
    (seed, subject_idx) and keeps each group's first highest score, in
    sorted group order;
  * ``get_bootstrap_ci`` averages the runs' bootstrap distributions
    element-wise (cut to the shortest) and takes ``np.percentile``'s
    linear percentiles;
  * ``get_condition_summary`` falls back to ±1.96 SEM (ddof-1 std of the
    seed means) where the bootstrap CI is missing or does not bracket the
    mean, and to NaN with one seed;
  * ``get_subject_scores`` is a {subject_idx: mean over seeds} dict in
    sorted subject order (pandas returns a Series);
  * ``get_best_layer_scores`` takes the first layer in sorted order where
    two layers' means tie.

``plot_brain_score_barplot`` writes its bars' means and the paired
t-tests against the 1000-class scores (scipy) as JSON, then draws where
matplotlib imports.
"""
from __future__ import annotations

import json
import sqlite3
from pathlib import Path
from typing import List

import numpy as np

from visreps_tpu_torch.core.db import RESULTS_DB_PATH
from visreps_tpu_torch.experiments.neurips_2025.figutils import (  # noqa: F401
    Table,
    _avg_over,
    avg_over_seed,
    draw_or_report,
    eq,
    from_records,
    group_agg,
    group_idxmax,
    groups,
    nanmean,
    nanstd,
    split_and_select_df,  # re-exported: plotter_utils' own in the JAX package
    write_series,
)

PROG = "plotters.plotter_utils"


def _connect(db_path=None):
    return sqlite3.connect(str(Path(db_path) if db_path else RESULTS_DB_PATH))


def _read(sql: str, params, db_path) -> Table:
    conn = _connect(db_path)
    try:
        cur = conn.execute(sql, params)
        names = [d[0] for d in cur.description]
        rows = cur.fetchall()
    finally:
        conn.close()
    return from_records(rows, names)


# ── queries ──────────────────────────────────────────────────────────

def query_best_scores(neural_dataset, region, pca_labels_folder, cfg_id,
                      compare_method: str = "spearman", epoch=None,
                      analysis: str = "rsa", db_path=None) -> Table:
    """The best-layer score per (seed, subject_idx) of ONE condition."""
    q = """SELECT run_id, seed, subject_idx, layer, score
           FROM results
           WHERE neural_dataset = ? AND region = ? AND pca_labels_folder = ?
             AND cfg_id = ? AND compare_method = ? AND analysis = ?
             AND reconstruct_from_pcs = 0"""
    params: list = [neural_dataset, region, pca_labels_folder, str(cfg_id),
                    compare_method, analysis]
    if epoch is not None:
        q += " AND epoch = ?"
        params.append(str(epoch))
    df = _read(q, params, db_path)
    if df.empty:
        return df
    for (seed, subj), rows in groups(df, ["seed", "subject_idx"]):
        if len(rows) > 1:
            print(f"WARNING: {len(rows)} duplicate rows for seed={seed}, subject_idx={subj} "
                  f"({neural_dataset}, {region}, {pca_labels_folder}, cfg_id={cfg_id}) "
                  "- keeping highest score")
    return df.take(group_idxmax(df, ["seed", "subject_idx"]))


def query_scores(neural_dataset, analysis: str = "rsa", compare_method: str = "spearman",
                 region: str | None = None, checkpoint_dir: str | None = None,
                 db_path=None) -> Table:
    """One row per stored result, for ad-hoc figures."""
    q = """SELECT run_id, cfg_id, seed, subject_idx, region, layer, score,
                  ci_low, ci_high, checkpoint_dir, model_name, epoch,
                  pca_labels, pca_n_classes, pca_labels_folder,
                  reconstruct_from_pcs, pca_k, neural_dataset
           FROM results WHERE neural_dataset=? AND analysis=? AND compare_method=?"""
    params: list = [neural_dataset, analysis, compare_method]
    if region is not None:
        q += " AND region=?"
        params.append(region)
    if checkpoint_dir is not None:
        q += " AND checkpoint_dir=?"
        params.append(checkpoint_dir)
    return _read(q, params, db_path)


def get_bootstrap_ci(run_ids, compare_method: str = "spearman", alpha: float = 0.05,
                     db_path=None):
    """(mean, ci_low, ci_high) of the element-wise mean of the runs'
    bootstrap distributions; NaNs without any."""
    if not run_ids:
        return np.nan, np.nan, np.nan
    conn = _connect(db_path)
    placeholders = ",".join("?" for _ in run_ids)
    rows = conn.execute(
        f"SELECT scores FROM bootstrap_distributions "
        f"WHERE run_id IN ({placeholders}) AND compare_method = ?",
        list(run_ids) + [compare_method],
    ).fetchall()
    conn.close()
    if not rows:
        return np.nan, np.nan, np.nan
    arrays = [np.asarray(json.loads(r[0]), np.float64) for r in rows]
    n = min(len(a) for a in arrays)
    mean_dist = np.mean([a[:n] for a in arrays], axis=0)
    return (float(np.mean(mean_dist)),
            float(np.percentile(mean_dist, 100 * alpha / 2)),
            float(np.percentile(mean_dist, 100 * (1 - alpha / 2))))


def get_condition_summary(neural_dataset, region, pca_labels_folder, cfg_id,
                          compare_method: str = "spearman", epoch=None,
                          analysis: str = "rsa", db_path=None) -> dict:
    """Mean and 95 % CI of one condition, with the SEM fallback."""
    df = query_best_scores(neural_dataset, region, pca_labels_folder, cfg_id,
                           compare_method, epoch, analysis, db_path)
    if df.empty:
        return {"mean": np.nan, "ci_low": np.nan, "ci_high": np.nan,
                "n_runs": 0, "run_ids": []}
    run_ids = df["run_id"].tolist()
    mean_score = nanmean(df["score"])
    _, ci_low, ci_high = get_bootstrap_ci(run_ids, compare_method, db_path=db_path)
    if np.isnan(ci_low) or ci_low > mean_score or ci_high < mean_score:
        seed_means = group_agg(df, "seed")["score"]
        if len(seed_means) > 1:
            sem = nanstd(seed_means, ddof=1) / np.sqrt(len(seed_means))
            ci_low, ci_high = mean_score - 1.96 * sem, mean_score + 1.96 * sem
        else:
            ci_low = ci_high = np.nan
    return {"mean": mean_score, "ci_low": ci_low, "ci_high": ci_high,
            "n_runs": len(df), "run_ids": run_ids}


def get_subject_scores(neural_dataset, region, pca_labels_folder, cfg_id,
                       compare_method: str = "spearman", epoch=None,
                       analysis: str = "rsa", db_path=None) -> dict:
    """{subject_idx: mean score over seeds}, subjects sorted."""
    df = query_best_scores(neural_dataset, region, pca_labels_folder, cfg_id,
                           compare_method, epoch, analysis, db_path)
    if df.empty:
        return {}
    by = group_agg(df, "subject_idx")
    return dict(zip(by["subject_idx"].tolist(), by["score"].tolist()))


# ── frame reshaping (the rest are figutils' copies) ──────────────────

def avg_over_subject_idx(df: Table) -> Table:
    """Collapse subject_idx; keep seed and the PCA columns."""
    return _avg_over(df, "subject_idx", "seed")


def avg_over_subject_idx_seed(df: Table) -> Table:
    return avg_over_seed(avg_over_subject_idx(df))


def get_best_layer_scores(df: Table, group_cols: List[str]) -> dict:
    """{group key: (the best layer's scores, best layer)}, the best layer
    by mean score (the first in sorted order on a tie)."""
    single = isinstance(group_cols, str) or len(group_cols) == 1
    result = {}
    for key, rows in groups(df, group_cols):
        g = df.take(rows)
        layer_means = group_agg(g, "layer")
        best_layer = layer_means["layer"][int(np.nanargmax(layer_means["score"]))]
        result[key[0] if single else key] = (
            g["score"][eq(g["layer"], best_layer)].tolist(), best_layer)
    return result


# ── architecture comparison bar plot ─────────────────────────────────

COLOR_MAP = {"alexnet": "#1f77b4", "vit": "#ee854a", "dino": "#ff7f0e",
             "clip": "#2d7f2d", "dreamsim": "#9467bd"}


def brain_score_bars(scores_by_arch_class: dict, pca_classes, architectures,
                     enable_significance: bool = True) -> dict:
    """The bars' means in drawing order, each with its paired t-test
    against the 1000-class scores (p, and a star where p < 0.01; p is
    None where the test does not apply), and the 1000-class mean."""
    from scipy import stats

    scores_1k = scores_by_arch_class.get(("1K", None))
    bars = []
    for n_cls in pca_classes:
        for arch in architectures:
            key = (arch, n_cls)
            if key not in scores_by_arch_class:
                continue
            scores = scores_by_arch_class[key]
            p = None
            if (enable_significance and scores_1k is not None
                    and len(scores) == len(scores_1k) and len(scores) > 1):
                p = float(stats.ttest_rel(scores, scores_1k)[1])
            bars.append({"architecture": arch, "n_classes": n_cls,
                         "mean": float(np.mean(scores)), "p": p,
                         "star": p is not None and p < 0.01})
    return {"bars": bars,
            "baseline_1k": None if scores_1k is None else float(np.mean(scores_1k))}


def _draw_barplot(data: dict, pca_classes, architectures, region_name: str, out_png: str,
                  ylabel: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.lines as mlines
    import matplotlib.patches as mpatches
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(14, 5.5))
    n_archs = len(architectures)
    bar_w, intra, gap = 0.24, 0.04, 0.30
    by_key = {(b["architecture"], b["n_classes"]): b for b in data["bars"]}
    tick_pos = []
    for i, n_cls in enumerate(pca_classes):
        base = i * (n_archs * bar_w + (n_archs - 1) * intra + gap)
        for ai, arch in enumerate(architectures):
            bar = by_key.get((arch, n_cls))
            if bar is None:
                continue
            pos = base + ai * (bar_w + intra)
            ax.bar(pos + bar_w / 2, bar["mean"], width=bar_w,
                   color=COLOR_MAP.get(arch, "#888888"), edgecolor="black",
                   linewidth=0.9, zorder=3)
            if bar["star"]:
                ax.text(pos + bar_w / 2, 0.01, "*", ha="center", va="bottom",
                        fontsize=16, fontweight="bold", color="white", zorder=4)
        width = n_archs * bar_w + (n_archs - 1) * intra
        tick_pos.append(base + width / 2)
    if data["baseline_1k"] is not None:
        ax.axhline(data["baseline_1k"], color="#666666", linestyle="--",
                   linewidth=2.0, alpha=0.9, zorder=2)
    ax.set_xticks(tick_pos)
    ax.set_xticklabels([str(c) for c in pca_classes], fontweight="bold")
    ax.set_ylabel(ylabel, fontsize=13)
    ax.set_title(region_name.title(), fontsize=15, fontweight="bold")
    handles = [mpatches.Patch(facecolor=COLOR_MAP.get(a, "#888888"),
                              edgecolor="black", label=f"{a} classes")
               for a in architectures]
    handles.append(mlines.Line2D([], [], color="#666666", linestyle="--",
                                 linewidth=2.0, label="ImageNet-1K"))
    ax.legend(handles=handles, loc="center left", bbox_to_anchor=(1, 0.5),
              frameon=True, fontsize=10)
    ax.spines["top"].set_visible(False)
    ax.spines["right"].set_visible(False)
    plt.tight_layout(rect=[0, 0, 0.86, 1])
    Path(out_png).parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(out_png, dpi=300, bbox_inches="tight", facecolor="white")
    plt.close(fig)
    print(f"Plot saved -> {out_png}")


def plot_brain_score_barplot(scores_by_arch_class: dict, pca_classes, architectures,
                             region_name: str, out_png: str,
                             enable_significance: bool = True,
                             ylabel: str = "Brain Similarity (RSA)") -> dict:
    """Grouped bars per (architecture, n_classes), the dashed 1000-class
    line and paired-t-test stars: the data as JSON beside ``out_png``,
    then the figure where matplotlib imports."""
    data = brain_score_bars(scores_by_arch_class, pca_classes, architectures,
                            enable_significance)
    write_series(out_png, data)
    draw_or_report(PROG, out_png, _draw_barplot, data, pca_classes, architectures,
                   region_name, out_png, ylabel)
    return data
