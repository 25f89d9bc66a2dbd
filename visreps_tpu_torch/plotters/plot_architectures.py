"""PCA-label-source comparison (port of ``plotters/plot_architectures.py``).

Grouped bars of every label source with rows in results.db (alexnet,
vit, dino, clip) across the 6 coarseness levels, with the ImageNet-1K
line and paired t-tests, and per-subject boxes at each source's best
coarse cfg. Each figure's data is written as JSON beside it; the figure
is drawn only where matplotlib imports.

Usage:
  python -m visreps_tpu_torch.plotters.plot_architectures --dataset nsd \\
      --region "ventral visual stream" [--db results.db]
"""
from __future__ import annotations

import argparse

import numpy as np

from visreps_tpu_torch.experiments.neurips_2025.figutils import (
    draw_or_report,
    nanmean,
    write_series,
)
from visreps_tpu_torch.plotters.plot_helpers import COARSE_CFGS, FULL_CFG, PCA_MODELS
from visreps_tpu_torch.plotters.plotter_utils import (
    get_subject_scores,
    plot_brain_score_barplot,
    query_best_scores,
)

PROG = "plotters.plot_architectures"
NEURAL_DATASET_MAP = {"nsd": "nsd", "tvsd": "tvsd", "things": "things-behavior",
                      "nsd_synthetic": "nsd_synthetic"}


def discover_architectures(nd: str, region: str, compare_method: str, db_path=None) -> list:
    """Label sources with at least one stored coarse row."""
    found = []
    for arch in PCA_MODELS:
        for cfg in COARSE_CFGS:
            if not query_best_scores(nd, region, f"pca_labels_{arch}", cfg, compare_method,
                                     db_path=db_path).empty:
                found.append(arch)
                break
    return found


def collect_scores(nd, region, architectures, compare_method, epoch, db_path=None) -> dict:
    """{(arch, n_classes) | ('1K', None): per-(seed × subject) scores}."""
    scores = {}
    for arch in architectures:
        for cfg in COARSE_CFGS:
            df = query_best_scores(nd, region, f"pca_labels_{arch}", cfg, compare_method,
                                   epoch=epoch, db_path=db_path)
            if not df.empty:
                scores[(arch, cfg)] = df["score"].tolist()
    df_1k = query_best_scores(nd, region, "imagenet1k", FULL_CFG, compare_method,
                              epoch=epoch, db_path=db_path)
    if not df_1k.empty:
        scores[("1K", None)] = df_1k["score"].tolist()
    return scores


def best_cfg_series(nd, region, architectures, compare_method, epoch, db_path=None) -> dict:
    """Each source's per-subject scores at its best coarse cfg (the first
    cfg with the highest mean), then ImageNet-1K's: {"labels", "series"}."""
    series, labels = [], []
    for arch in architectures:
        best_cfg, best_mean, best_sm = None, -np.inf, None
        for cfg in COARSE_CFGS:
            sm = get_subject_scores(nd, region, f"pca_labels_{arch}", cfg, compare_method,
                                    epoch=epoch, db_path=db_path)
            if len(sm) and nanmean(list(sm.values())) > best_mean:
                best_cfg, best_mean, best_sm = cfg, nanmean(list(sm.values())), sm
        if best_sm is not None:
            series.append(list(best_sm.values()))
            labels.append(f"{PCA_MODELS.get(arch, arch)}\n(best: {best_cfg})")
    sm_1k = get_subject_scores(nd, region, "imagenet1k", FULL_CFG, compare_method,
                               epoch=epoch, db_path=db_path)
    if len(sm_1k):
        series.append(list(sm_1k.values()))
        labels.append("ImageNet-1K")
    return {"labels": labels, "series": series}


def _draw_per_subject_best_cfg(data: dict, nd: str, region: str, out_png: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    series = [np.asarray(s, float) for s in data["series"]]
    fig, ax = plt.subplots(figsize=(1.6 * len(series) + 2, 4))
    bp = ax.boxplot(series, patch_artist=True, widths=0.5,
                    medianprops=dict(color="black", linewidth=1.4))
    for patch in bp["boxes"]:
        patch.set_facecolor("#9ecae1")
        patch.set_alpha(0.7)
    rng = np.random.default_rng(42)
    for i, y in enumerate(series, start=1):
        ax.scatter(rng.normal(i, 0.05, len(y)), y, s=22, c="white",
                   edgecolors="black", linewidths=0.7, zorder=3)
    ax.set_xticklabels(data["labels"], fontsize=9)
    ax.set_ylabel("Alignment score")
    ax.set_title(f"{nd.upper()} {region}", fontweight="bold")
    ax.spines["top"].set_visible(False)
    ax.spines["right"].set_visible(False)
    plt.tight_layout()
    fig.savefig(out_png, dpi=200, bbox_inches="tight", facecolor="white")
    plt.close(fig)
    print(f"Saved -> {out_png}")


def plot_per_subject_best_cfg(nd, region, architectures, compare_method, epoch, out_png,
                              db_path=None):
    """Boxes of per-subject scores at each source's best coarse cfg: the
    data as JSON, then the figure; None without any rows."""
    data = best_cfg_series(nd, region, architectures, compare_method, epoch, db_path)
    if not data["series"]:
        print("No data for per-subject architecture figure")
        return None
    write_series(out_png, data)
    draw_or_report(PROG, out_png, _draw_per_subject_best_cfg, data, nd, region, out_png)
    return out_png


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", default="nsd", choices=list(NEURAL_DATASET_MAP))
    parser.add_argument("--region", default="ventral visual stream")
    parser.add_argument("--analysis", default="rsa")
    parser.add_argument("--compare_method", default="spearman")
    parser.add_argument("--epoch", type=int, default=20)
    parser.add_argument("--out-dir", default="plotters/figures")
    parser.add_argument("--db", default=None)
    args = parser.parse_args(argv)

    nd = NEURAL_DATASET_MAP[args.dataset]
    archs = discover_architectures(nd, args.region, args.compare_method, args.db)
    if not archs:
        print(f"No PCA-label-source rows found for {nd} / {args.region}")
        return None
    print(f"Discovered label sources: {archs}")
    scores = collect_scores(nd, args.region, archs, args.compare_method, args.epoch, args.db)
    slug = args.region.replace(" ", "_")
    ylabel = ("Brain Similarity (Encoding r)" if args.analysis == "encoding_score"
              else "Brain Similarity (RSA)")
    bars = f"{args.out_dir}/architectures_{args.dataset}_{slug}.png"
    boxes = f"{args.out_dir}/architectures_per_subject_{args.dataset}_{slug}.png"
    plot_brain_score_barplot(scores, COARSE_CFGS, archs, f"{args.dataset} {args.region}",
                             bars, ylabel=ylabel)
    plot_per_subject_best_cfg(nd, args.region, archs, args.compare_method, args.epoch,
                              boxes, db_path=args.db)
    return {"architectures": archs, "bars": bars, "boxes": boxes}


if __name__ == "__main__":
    main()
