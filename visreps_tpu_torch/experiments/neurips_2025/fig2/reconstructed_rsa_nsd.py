"""Fig. 2, NSD reconstructed-RSA curve (port of
``experiments/neurips_2025/fig2/reconstructed_rsa_nsd.py``).

The RSA score of the 1000-way model reconstructed from its top-k PCs as
a function of k (per-seed curves, subjects averaged) for one (region,
layer), against the untrained-model and best-coarse-model bands, from
the long results CSVs without pandas (``figutils.read_csv``). The
series are written as JSON beside the figure, which is drawn where
matplotlib imports.

Usage:
  python -m visreps_tpu_torch.experiments.neurips_2025.fig2.reconstructed_rsa_nsd \\
      --recon_csv logs/pc_reconstruction_analysis.csv --baseline_csv logs/full-vs-pcs_nsd.csv
"""
from __future__ import annotations

import argparse

import numpy as np

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.experiments.neurips_2025.figutils import (
    Table,
    draw_or_report,
    eq,
    group_agg,
    nanmean,
    nanstd,
    read_csv,
    reconstructed_rsa_plot,
    str_lower,
    write_series,
)


def _filter(df: Table, region, layer, metric, **eq_cols) -> Table:
    m = eq(str_lower(df["region"]), region.lower()) & eq(str_lower(df["layer"]), layer.lower())
    if "correlation" in df:
        m &= eq(str_lower(df["correlation"]), metric.lower())
    for col, val in eq_cols.items():
        if col in df:
            m &= eq(df[col], val)
    return df.take(m)


def pivot_seeds(sub: Table, max_k: int) -> np.ndarray:
    """(n_seeds, max_k): per-(seed, pca_k) mean scores, seeds sorted, NaN
    where a k is missing (``groupby → pivot_table → reindex``: seeds and
    ks with no score are dropped before the reindex)."""
    by = group_agg(sub, ["seed", "pca_k"])
    keep = ~np.isnan(by["score"])
    seeds = sorted(set(by["seed"][keep].tolist()))
    out = np.full((len(seeds), max_k), np.nan)
    for s, k, v in zip(by["seed"][keep].tolist(), by["pca_k"][keep].tolist(),
                       by["score"][keep].tolist()):
        if k in range(1, max_k + 1):
            out[seeds.index(s), int(k) - 1] = v
    return out


def recon_matrix(df: Table, region, layer, metric, max_k=20) -> np.ndarray:
    """(n_seeds, max_k) per-seed curves, subjects averaged."""
    return pivot_seeds(_filter(df, region, layer, metric, reconstruct_from_pcs=True), max_k)


def baseline_band(df: Table, region, layer, metric, **eq_cols):
    """(mean, std) over seeds with subjects averaged within seed."""
    sub = _filter(df, region, layer, metric, **eq_cols)
    if sub.empty:
        return None
    seed_means = group_agg(sub, "seed")["score"]
    return float(nanmean(seed_means)), float(nanstd(seed_means, ddof=0))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--recon_csv", default="logs/pc_reconstruction_analysis.csv")
    parser.add_argument("--baseline_csv", default="logs/full-vs-pcs_nsd.csv")
    parser.add_argument("--region", default="ventral visual stream")
    parser.add_argument("--layer", default="fc1")
    parser.add_argument("--metric", default="Spearman")
    parser.add_argument("--best_pc_n_classes", type=int, default=64)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    recon = recon_matrix(read_csv(args.recon_csv), args.region, args.layer, args.metric)
    if np.isnan(recon).all():
        rprint("No reconstruction data for the requested slice.", style="error")
        return None

    base_df = read_csv(args.baseline_csv)
    untrained = baseline_band(base_df, args.region, args.layer, args.metric, epoch=0)
    best_pc = baseline_band(base_df, args.region, args.layer, args.metric,
                            epoch=20, pca_n_classes=args.best_pc_n_classes)
    out = args.out or f"plotters/fig2/reconstructed_rsa_nsd_{args.region[:6]}.png"
    series = {"recon": recon, "untrained": untrained, "best_pc": best_pc}
    write_series(out, series)
    draw_or_report("fig2.reconstructed_rsa_nsd", out, reconstructed_rsa_plot, recon, out,
                   untrained=untrained, best_pc=best_pc,
                   best_pc_n_classes=args.best_pc_n_classes, ylabel=f"RSA ({args.metric})")
    return series


if __name__ == "__main__":
    main()
