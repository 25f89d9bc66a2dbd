"""NSD coarseness figures, stream and fine-grained ROI presets (port of
``plotters/nsd/plot_coarseness.py``): the (2, 4) fine-grained grid with
V1–hV4 on top and FFA / PPA centred below, and the encoding-score
variant. Series as JSON beside each figure; drawn where matplotlib
imports.

Usage:
  python -m visreps_tpu_torch.plotters.nsd.plot_coarseness --pca_labels alexnet \\
      --regions streams|finegrained [--analysis rsa|encoding_score] [--db results.db]
"""
from __future__ import annotations

import argparse

from visreps_tpu_torch.plotters.plot_helpers import (
    PCA_MODELS,
    plot_coarseness_bars,
    plot_per_subject,
)

REGION_PRESETS = {
    "streams": {
        "regions": ["early visual stream", "ventral visual stream"],
        "region_labels": {
            "early visual stream": "Early Visual Stream",
            "ventral visual stream": "Ventral Visual Stream",
        },
        "output_suffix": "",
    },
    "finegrained": {
        "regions": ["V1", "V2", "V3", "hV4", "FFA", "PPA"],
        "region_labels": {r: r for r in ["V1", "V2", "V3", "hV4", "FFA", "PPA"]},
        "layout": (2, 4, [(0, 0), (0, 1), (0, 2), (0, 3), (1, 1), (1, 2)]),
        "output_suffix": "_finegrained",
    },
}
OUTPUT_DIR = "plotters/nsd/figures"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pca_labels", default="alexnet", choices=list(PCA_MODELS))
    p.add_argument("--regions", default="streams", choices=list(REGION_PRESETS))
    p.add_argument("--analysis", default="rsa", choices=["rsa", "encoding_score"])
    p.add_argument("--compare_method", default=None, choices=["spearman", "pearson", "kendall"])
    p.add_argument("--out-dir", default=OUTPUT_DIR)
    p.add_argument("--db", default=None)
    args = p.parse_args(argv)

    preset = REGION_PRESETS[args.regions]
    suffix = preset["output_suffix"]
    if args.analysis == "encoding_score":
        suffix += "_encoding"
    dcfg = {
        "neural_dataset": "nsd",
        "has_subjects": True,
        "analysis": args.analysis,
        "compare_method": args.compare_method or (
            "pearson" if args.analysis == "encoding_score" else "spearman"),
        **{k: v for k, v in preset.items() if k != "output_suffix"},
        "output_suffix": suffix,
    }
    return (plot_coarseness_bars(dcfg, args.pca_labels, args.out_dir,
                                 dataset_label="NSD", db_path=args.db),
            plot_per_subject(dcfg, args.pca_labels, args.out_dir,
                             dataset_label="NSD", db_path=args.db))


if __name__ == "__main__":
    main()
