"""Fig. 4, NSD full model vs coarse models per layer (port of
``experiments/neurips_2025/fig4/full_vs_pcs_nsd.py``): fig. 3's
per-layer comparison for one NSD region (Blues), without pandas. The
series are written as JSON beside the figure, which is drawn where
matplotlib imports.

Usage:
  python -m visreps_tpu_torch.experiments.neurips_2025.fig4.full_vs_pcs_nsd \\
      --csv logs/full-vs-pcs_nsd.csv --region "ventral visual stream"
"""
from __future__ import annotations

import argparse

from visreps_tpu_torch.experiments.neurips_2025.fig3.full_vs_pcs_things import (
    LAYER_ORDER,
    prepare_series,
)
from visreps_tpu_torch.experiments.neurips_2025.figutils import (
    PCA_SIZES,
    draw_or_report,
    eq,
    layer_comparison_plot,
    read_csv,
    str_lower,
    write_series,
)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--csv", default="logs/full-vs-pcs_nsd.csv")
    parser.add_argument("--metric", default="Spearman")
    parser.add_argument("--region", default="ventral visual stream")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    df = read_csv(args.csv)
    df = df.take(eq(str_lower(df["region"]), args.region.lower()))
    initial, final, pca = prepare_series(df, args.metric, LAYER_ORDER)
    pca = {n: v for n, v in pca.items() if n in PCA_SIZES}
    out = args.out or (
        f"plotters/fig4/full_vs_pcs_nsd_{args.region.lower().replace(' ', '_')}.png")
    series = {"initial": initial, "final": final, "pca": pca}
    write_series(out, series)
    draw_or_report("fig4.full_vs_pcs_nsd", out, layer_comparison_plot, initial, final, pca,
                   LAYER_ORDER, out, ylabel=f"RSA ({args.metric})", colors="Blues")
    return series


if __name__ == "__main__":
    main()
