"""TVSD (macaque MUA) coarseness figures: V1 / V4 / IT (port of
``plotters/tvsd/plot_coarseness.py``). Series as JSON beside each figure;
drawn where matplotlib imports.

Usage:
  python -m visreps_tpu_torch.plotters.tvsd.plot_coarseness --pca_labels alexnet \\
      [--compare_method spearman] [--db results.db]
"""
from __future__ import annotations

import argparse

from visreps_tpu_torch.plotters.plot_helpers import (
    PCA_MODELS,
    plot_coarseness_bars,
    plot_per_subject,
)

OUTPUT_DIR = "plotters/tvsd/figures"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pca_labels", default="alexnet", choices=list(PCA_MODELS))
    p.add_argument("--compare_method", default="spearman",
                   choices=["spearman", "pearson", "kendall"])
    p.add_argument("--out-dir", default=OUTPUT_DIR)
    p.add_argument("--db", default=None)
    args = p.parse_args(argv)

    dcfg = {
        "neural_dataset": "tvsd",
        "has_subjects": True,  # 2 monkeys
        "analysis": "rsa",
        "compare_method": args.compare_method,
        "regions": ["V1", "V4", "IT"],
        "region_labels": {"V1": "V1", "V4": "V4", "IT": "IT"},
        "output_suffix": "",
    }
    return (plot_coarseness_bars(dcfg, args.pca_labels, args.out_dir,
                                 dataset_label="TVSD", db_path=args.db),
            plot_per_subject(dcfg, args.pca_labels, args.out_dir,
                             dataset_label="TVSD", db_path=args.db))


if __name__ == "__main__":
    main()
