"""NSD-Synthetic coarseness figures: out-of-distribution stimuli, both
streams (port of ``plotters/nsd_synthetic/plot_coarseness.py``). Series
as JSON beside each figure; drawn where matplotlib imports.

Usage:
  python -m visreps_tpu_torch.plotters.nsd_synthetic.plot_coarseness --pca_labels alexnet \\
      [--compare_method spearman] [--db results.db]
"""
from __future__ import annotations

import argparse

from visreps_tpu_torch.plotters.plot_helpers import (
    PCA_MODELS,
    plot_coarseness_bars,
    plot_per_subject,
)

OUTPUT_DIR = "plotters/nsd_synthetic/figures"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pca_labels", default="alexnet", choices=list(PCA_MODELS))
    p.add_argument("--compare_method", default="spearman",
                   choices=["spearman", "pearson", "kendall"])
    p.add_argument("--out-dir", default=OUTPUT_DIR)
    p.add_argument("--db", default=None)
    args = p.parse_args(argv)

    dcfg = {
        "neural_dataset": "nsd_synthetic",
        "has_subjects": True,
        "analysis": "rsa",
        "compare_method": args.compare_method,
        "regions": ["early visual stream", "ventral visual stream"],
        "region_labels": {
            "early visual stream": "Early Visual Stream",
            "ventral visual stream": "Ventral Visual Stream",
        },
        "output_suffix": "",
    }
    return (plot_coarseness_bars(dcfg, args.pca_labels, args.out_dir,
                                 dataset_label="NSD-Synthetic", db_path=args.db),
            plot_per_subject(dcfg, args.pca_labels, args.out_dir,
                             dataset_label="NSD-Synthetic", db_path=args.db))


if __name__ == "__main__":
    main()
