"""THINGS behavioural-embedding coarseness figure, no subjects (port of
``plotters/things/plot_coarseness.py``). Series as JSON beside each
figure; drawn where matplotlib imports.

Usage:
  python -m visreps_tpu_torch.plotters.things.plot_coarseness --pca_labels alexnet \\
      [--compare_method spearman] [--db results.db]
"""
from __future__ import annotations

import argparse

from visreps_tpu_torch.plotters.plot_helpers import (
    PCA_MODELS,
    plot_coarseness_bars,
    plot_per_subject,
)

OUTPUT_DIR = "plotters/things/figures"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pca_labels", default="alexnet", choices=list(PCA_MODELS))
    p.add_argument("--compare_method", default="spearman",
                   choices=["spearman", "pearson", "kendall"])
    p.add_argument("--out-dir", default=OUTPUT_DIR)
    p.add_argument("--db", default=None)
    args = p.parse_args(argv)

    dcfg = {
        "neural_dataset": "things-behavior",
        "has_subjects": False,
        "analysis": "rsa",
        "compare_method": args.compare_method,
        "regions": ["N/A"],
        "region_labels": {"N/A": "Behavioral Embedding"},
        "output_suffix": "",
    }
    return (plot_coarseness_bars(dcfg, args.pca_labels, args.out_dir,
                                 dataset_label="THINGS", db_path=args.db),
            plot_per_subject(dcfg, args.pca_labels, args.out_dir,
                             dataset_label="THINGS", db_path=args.db))


if __name__ == "__main__":
    main()
