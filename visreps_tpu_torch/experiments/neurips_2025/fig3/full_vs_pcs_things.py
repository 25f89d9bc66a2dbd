"""Fig. 3, THINGS full model vs coarse models per layer (port of
``experiments/neurips_2025/fig3/full_vs_pcs_things.py``): per-layer RSA
of the untrained, 1000-way and each coarse model, averaged over seeds
(the port's ``split_and_select_df`` / ``avg_over_seed`` in
``figutils``), without pandas. The series are written as JSON beside the
figure, which is drawn where matplotlib imports.

Usage:
  python -m visreps_tpu_torch.experiments.neurips_2025.fig3.full_vs_pcs_things \\
      --csv logs/full-vs-pcs_things.csv
"""
from __future__ import annotations

import argparse

from visreps_tpu_torch.experiments.neurips_2025.figutils import (
    PCA_SIZES,
    Table,
    avg_over_seed,
    draw_or_report,
    groups,
    layer_comparison_plot,
    read_csv,
    split_and_select_df,
    write_series,
)

LAYER_ORDER = ["conv1", "conv2", "conv3", "conv4", "conv5", "fc1", "fc2"]


def _by_layer(df: Table) -> dict:
    """{layer: score}; a layer's later row wins, as ``dict(zip(...))``."""
    return dict(zip(df["layer"].tolist(), df["score"].tolist())) if "layer" in df else {}


def prepare_series(df: Table, metric, layers, dataset=None):
    """(initial, final, {n: per-layer dict}) from the long table."""
    pca_df, full_df = split_and_select_df(df, dataset=dataset, metric=metric,
                                          epoch=20, layers=layers)
    _, initial_df = split_and_select_df(df, dataset=dataset, metric=metric,
                                        epoch=0, layers=layers)
    pca_df, full_df, initial_df = (avg_over_seed(pca_df), avg_over_seed(full_df),
                                   avg_over_seed(initial_df))
    pca = {key[0]: _by_layer(pca_df.take(rows))
           for key, rows in groups(pca_df, "pca_n_classes")}
    return _by_layer(initial_df), _by_layer(full_df), pca


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--csv", default="logs/full-vs-pcs_things.csv")
    parser.add_argument("--metric", default="Spearman")
    parser.add_argument("--out", default="plotters/fig3/full_vs_pcs_things.png")
    args = parser.parse_args(argv)

    initial, final, pca = prepare_series(read_csv(args.csv), args.metric, LAYER_ORDER)
    pca = {n: v for n, v in pca.items() if n in PCA_SIZES}
    series = {"initial": initial, "final": final, "pca": pca}
    write_series(args.out, series)
    draw_or_report("fig3.full_vs_pcs_things", args.out, layer_comparison_plot, initial, final,
                   pca, LAYER_ORDER, args.out, ylabel=f"RSA ({args.metric})", colors="Greens")
    return series


if __name__ == "__main__":
    main()
