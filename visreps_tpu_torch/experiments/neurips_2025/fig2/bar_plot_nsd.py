"""Fig. 2, NSD condition bar plot (port of
``experiments/neurips_2025/fig2/bar_plot_nsd.py``).

The long results CSV filtered to one region, subjects collapsed per
seed, and {condition: per-seed scores} for the untrained, 2–64-class
and 1000-class models (``figutils.assemble_conditions``), without
pandas. The scores are written as JSON beside the figure, which is
drawn where matplotlib imports.

Usage:
  python -m visreps_tpu_torch.experiments.neurips_2025.fig2.bar_plot_nsd \\
      --csv logs/full-vs-pcs_nsd.csv --region "early visual stream"
"""
from __future__ import annotations

import argparse

from visreps_tpu_torch.experiments.neurips_2025.figutils import (
    PCA_SIZES,
    assemble_conditions,
    condition_barplot,
    draw_or_report,
    eq,
    read_csv,
    str_lower,
    write_series,
)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--csv", default="logs/full-vs-pcs_nsd.csv")
    parser.add_argument("--pc_layer", default="conv4")
    parser.add_argument("--k1k_layer", default="conv3")
    parser.add_argument("--region", default="early visual stream")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    df = read_csv(args.csv)
    df = df.take(eq(str_lower(df["region"]), args.region.lower()))
    scores = assemble_conditions(df, args.pc_layer, args.k1k_layer, PCA_SIZES)
    out = args.out or (
        f"plotters/fig2/barplt_{args.pc_layer}_region_"
        f"{args.region.lower().replace(' ', '_')}.png")
    write_series(out, scores)
    draw_or_report("fig2.bar_plot_nsd", out, condition_barplot, scores, out)
    return scores


if __name__ == "__main__":
    main()
