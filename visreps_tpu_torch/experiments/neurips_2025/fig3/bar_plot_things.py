"""Fig. 3, THINGS condition bar plot (port of
``experiments/neurips_2025/fig3/bar_plot_things.py``): fig. 2's
condition bars on the THINGS behavioural results (no region), Greens,
without pandas. The scores are written as JSON beside the figure, which
is drawn where matplotlib imports.

Usage:
  python -m visreps_tpu_torch.experiments.neurips_2025.fig3.bar_plot_things \\
      --csv logs/full-vs-pcs_things.csv
"""
from __future__ import annotations

import argparse

from visreps_tpu_torch.experiments.neurips_2025.figutils import (
    PCA_SIZES,
    assemble_conditions,
    condition_barplot,
    draw_or_report,
    read_csv,
    write_series,
)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--csv", default="logs/full-vs-pcs_things.csv")
    parser.add_argument("--pc_layer", default="fc2")
    parser.add_argument("--k1k_layer", default="fc2")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    scores = assemble_conditions(read_csv(args.csv), args.pc_layer, args.k1k_layer, PCA_SIZES)
    out = args.out or f"plotters/fig3/barplt_things_{args.pc_layer}.png"
    write_series(out, scores)
    draw_or_report("fig3.bar_plot_things", out, condition_barplot, scores, out,
                   ylabel="Behavioral Similarity (RSA)", palette_name="Greens")
    return scores


if __name__ == "__main__":
    main()
