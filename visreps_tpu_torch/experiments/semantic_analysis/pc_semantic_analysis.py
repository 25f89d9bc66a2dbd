"""Semantic-category enrichment at the poles of a principal component
(port of ``experiments/semantic_analysis/pc_semantic_analysis.py``).

Features projected onto PC k (numpy on the host, as in the JAX package:
the eigenvectors come from the npz, so no sign is chosen here), the low
and high percentile poles, and each category's share of a pole against
its share over all images (enrichment = pole % − base %). Categories are
NLTK WordNet ancestors at a hierarchy level (nltk imported only there),
or an ``--ancestors-csv`` of image,category rows — the route where no
WordNet corpus is installed. The enrichment tables are written as JSON
beside the histogram, which is drawn only where matplotlib imports.

Usage:
  python -m visreps_tpu_torch.experiments.semantic_analysis.pc_semantic_analysis \
      --features features.npz --eigenvectors eig.npz --pc 1 \
      [--level 6 | --ancestors-csv cats.csv] --out-dir pc_histograms
"""
from __future__ import annotations

import argparse
import csv
import os
import sys
from collections import Counter
from pathlib import Path

import numpy as np

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.experiments.neurips_2025.figutils import draw_or_report, write_series

PROG = "semantic_analysis.pc_semantic_analysis"


def wordnet_ancestors(image_names, level: int):
    """Ancestor synset name per image at the given hierarchy level.

    nltk is imported here: ImportError where it is not installed,
    LookupError where its WordNet corpus is not.
    """
    from nltk.corpus import wordnet as wn

    wn.ensure_loaded()
    out = []
    for name in image_names:
        wnid = os.path.basename(str(name)).split("_")[0]
        try:
            synset = wn.synset_from_pos_and_offset("n", int(wnid[1:]))
        except Exception:
            out.append("unknown")
            continue
        paths = synset.hypernym_paths()
        anc = synset if (not paths or level >= len(paths[0])) else paths[0][level]
        out.append(anc.name())
    return out


def csv_ancestors(image_names, csv_path: str):
    with open(csv_path) as f:
        reader = csv.DictReader(f)
        cat_col = "category" if "category" in reader.fieldnames else "pca_label"
        mapping = {row["image"]: row[cat_col] for row in reader}
    return [mapping.get(os.path.basename(str(n)), "unknown") for n in image_names]


def enrichment_vs_baseline(pole_ancestors, baseline_counts, n_baseline,
                           min_count: int):
    """Per-category pole% − baseline% with a minimum-count filter."""
    pole_counts = Counter(pole_ancestors)
    n_pole = len(pole_ancestors)
    results = []
    for cat, count in pole_counts.items():
        if count < min_count:
            continue
        pole_pct = count / n_pole * 100
        base_pct = baseline_counts.get(cat, 0) / n_baseline * 100
        results.append({
            "category": str(cat).split(".")[0],
            "count": count,
            "pole_pct": pole_pct,
            "baseline_pct": base_pct,
            "enrichment": pole_pct - base_pct,
        })
    results.sort(key=lambda x: x["enrichment"], reverse=True)
    return results


def analyze_pc(scores: np.ndarray, ancestors, percentile: int = 20) -> dict:
    """Pole enrichment: the categories of the scores at or below the
    ``percentile`` and at or above 100 − ``percentile``."""
    low_mask = scores <= np.percentile(scores, percentile)
    high_mask = scores >= np.percentile(scores, 100 - percentile)
    n_low, n_high = int(low_mask.sum()), int(high_mask.sum())

    baseline_counts = Counter(ancestors)
    n_baseline = len(ancestors)
    low_anc = [a for a, m in zip(ancestors, low_mask) if m]
    high_anc = [a for a, m in zip(ancestors, high_mask) if m]

    return {
        "low_enriched": enrichment_vs_baseline(
            low_anc, baseline_counts, n_baseline, max(1, int(n_low * 0.005))),
        "high_enriched": enrichment_vs_baseline(
            high_anc, baseline_counts, n_baseline, max(1, int(n_high * 0.005))),
        "n_low": n_low, "n_high": n_high, "n_total": len(ancestors),
        "all_ancestors": ancestors,
    }


def print_results(results: dict, pc: int):
    for pole in ("low", "high"):
        rows = [r for r in results[f"{pole}_enriched"] if r["enrichment"] > 0]
        rprint(f"--- PC{pc} {pole.upper()} POLE (n={results[f'n_{pole}']:,}) ---",
               style="info")
        for r in rows:
            rprint(
                f"  {r['category']:<25} {r['count']:>6} {r['pole_pct']:>6.1f}% "
                f"{r['baseline_pct']:>6.1f}% {r['enrichment']:>+7.1f}%",
                style="highlight",
            )


def plot_histogram(scores, results, pc: int, out_path: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ancestors = results["all_ancestors"]
    top_low = [r["category"] for r in results["low_enriched"] if r["enrichment"] > 0][:3]
    top_high = [r["category"] for r in results["high_enriched"] if r["enrichment"] > 0][:3]
    low_colors = ["#1f77b4", "#6baed6", "#9ecae1"]
    high_colors = ["#d62728", "#fc8d62", "#fdae6b"]

    plt.figure(figsize=(12, 6))
    for cats, colors, tag in ((top_low, low_colors, "low"), (top_high, high_colors, "high")):
        for i, cat in enumerate(cats):
            cat_scores = [scores[j] for j, anc in enumerate(ancestors)
                          if str(anc).split(".")[0] == cat]
            if cat_scores:
                plt.hist(cat_scores, bins=50, alpha=0.5, label=f"{cat} ({tag})",
                         color=colors[i], density=True)
    plt.xlabel(f"PC{pc} Score")
    plt.ylabel("Density")
    plt.title(f"PC{pc} Distribution by Category")
    plt.legend(loc="upper right")
    plt.tight_layout()
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(out_path, dpi=150)
    plt.close()


def main(argv=None):
    """Returns the ``analyze_pc`` result."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--features", required=True,
                        help=".npz with a features array + image_names")
    parser.add_argument("--eigenvectors", required=True,
                        help=".npz with 'eigenvectors' and 'mean'")
    parser.add_argument("--pc", type=int, default=1, help="1-indexed PC")
    parser.add_argument("--level", type=int, default=6, help="WordNet level")
    parser.add_argument("--ancestors-csv", default=None,
                        help="image,category CSV (bypasses WordNet)")
    parser.add_argument("--percentile", type=int, default=20)
    parser.add_argument("--out-dir", default="experiments/semantic_analysis/pc_histogram")
    args = parser.parse_args(argv)

    feats_data = np.load(args.features, allow_pickle=True)
    feat_key = [k for k in feats_data if "features" in k and k != "image_names"][0]
    names = feats_data["image_names"]
    if names.size and isinstance(names[0], (bytes, np.bytes_)):
        names = np.array([n.decode() for n in names])
    features = feats_data[feat_key].reshape(len(names), -1)
    eig = np.load(args.eigenvectors)

    scores = ((features - eig["mean"]) @ eig["eigenvectors"][:, args.pc - 1]).ravel()

    if args.ancestors_csv:
        ancestors = csv_ancestors(names, args.ancestors_csv)
    else:
        try:
            ancestors = wordnet_ancestors(names, args.level)
        except LookupError:
            rprint("WordNet corpus unavailable; pass --ancestors-csv instead.", style="error")
            sys.exit(2)

    results = analyze_pc(scores, ancestors, args.percentile)
    print_results(results, args.pc)
    out_png = os.path.join(args.out_dir, f"pc{args.pc}_histogram.png")
    write_series(out_png, {k: results[k] for k in ("low_enriched", "high_enriched", "n_low",
                                                   "n_high", "n_total")})
    draw_or_report(PROG, out_png, plot_histogram, scores, results, args.pc, out_png)
    return results


if __name__ == "__main__":
    main()
