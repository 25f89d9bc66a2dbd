"""Fig. 3, THINGS reconstructed-RSA curve (port of
``experiments/neurips_2025/fig3/reconstructed_rsa_things.py``): fig. 2's
curve against its baseline bands on the THINGS behavioural results (no
region), without pandas. The series are written as JSON beside the
figure, which is drawn where matplotlib imports.

Usage:
  python -m visreps_tpu_torch.experiments.neurips_2025.fig3.reconstructed_rsa_things \\
      --recon_csv logs/pc_reconstruction_things.csv --baseline_csv logs/full-vs-pcs_things.csv
"""
from __future__ import annotations

import argparse

import numpy as np

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.experiments.neurips_2025.fig2.reconstructed_rsa_nsd import pivot_seeds
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


def _layer_metric(df: Table, layer, metric) -> Table:
    m = eq(str_lower(df["layer"]), layer.lower())
    if "correlation" in df:
        m &= eq(str_lower(df["correlation"]), metric.lower())
    return df.take(m)


def recon_matrix(df: Table, layer, metric, max_k=20) -> np.ndarray:
    """(n_seeds, max_k) per-seed curves of the ``reconstruct_from_pcs``
    rows (every row without that column), subjects averaged."""
    if "reconstruct_from_pcs" in df:
        df = df.take(eq(df["reconstruct_from_pcs"], True))
    return pivot_seeds(_layer_metric(df, layer, metric), max_k)


def baseline_band(df: Table, layer, metric, **eq_cols):
    sub = _layer_metric(df, layer, metric)
    for col, val in eq_cols.items():
        if col in sub:
            sub = sub.take(eq(sub[col], val))
    if sub.empty:
        return None
    seed_means = group_agg(sub, "seed")["score"]
    return float(nanmean(seed_means)), float(nanstd(seed_means, ddof=0))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--recon_csv", default="logs/pc_reconstruction_things.csv")
    parser.add_argument("--baseline_csv", default="logs/full-vs-pcs_things.csv")
    parser.add_argument("--layer", default="fc2")
    parser.add_argument("--metric", default="Spearman")
    parser.add_argument("--best_pc_n_classes", type=int, default=64)
    parser.add_argument("--out", default="plotters/fig3/reconstructed_rsa_things.png")
    args = parser.parse_args(argv)

    recon = recon_matrix(read_csv(args.recon_csv), args.layer, args.metric)
    if np.isnan(recon).all():
        rprint("No reconstruction data for the requested slice.", style="error")
        return None
    base_df = read_csv(args.baseline_csv)
    untrained = baseline_band(base_df, args.layer, args.metric, epoch=0)
    best_pc = baseline_band(base_df, args.layer, args.metric, epoch=20,
                            pca_n_classes=args.best_pc_n_classes)
    series = {"recon": recon, "untrained": untrained, "best_pc": best_pc}
    write_series(args.out, series)
    draw_or_report("fig3.reconstructed_rsa_things", args.out, reconstructed_rsa_plot, recon,
                   args.out, untrained=untrained, best_pc=best_pc,
                   best_pc_n_classes=args.best_pc_n_classes, ylabel=f"RSA ({args.metric})")
    return series


if __name__ == "__main__":
    main()
