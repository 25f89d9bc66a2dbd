"""Shared coarseness-figure logic (port of ``plotters/plot_helpers.py``).

Each per-dataset CLI passes a dataset config (regions, region labels,
whether it has subjects, an optional (rows, cols, positions) layout) and
a PCA-label source. The two figures are (1) per region an untrained |
2–64-class (hatched blues) | axis break | 1000-class bar panel with the
conditions' CIs, and (2) per-subject boxes with the seed-averaged
subjects joined across class counts. Each writes its series as JSON
beside the PNG (``figutils.write_series``) and draws only where
matplotlib imports; the module imports without matplotlib, so the
colours are constants (``BLUES`` equals matplotlib's "Blues" samples).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from visreps_tpu_torch.experiments.neurips_2025.figutils import draw_or_report, write_series
from visreps_tpu_torch.plotters.plotter_utils import get_condition_summary, get_subject_scores

PROG = "plotters.plot_helpers"

COARSE_CFGS = [2, 4, 8, 16, 32, 64]
N_COARSE = len(COARSE_CFGS)
FULL_CFG = 1000

PCA_MODELS = {"alexnet": "AlexNet", "vit": "ViT", "clip": "CLIP", "dino": "DINO"}
FOLDER_DISPLAY = {f"pca_labels_{k}": v for k, v in PCA_MODELS.items()}

# matplotlib's "Blues" at 0.25 + 0.65 · i / 5, i = 0..5
BLUES = [
    (0.7752402921953095, 0.8583006535947711, 0.9368242983467897, 1.0),
    (0.6109803921568627, 0.7874202229911572, 0.8804921184159938, 1.0),
    (0.4069973087274125, 0.6737408688965782, 0.8342945021145713, 1.0),
    (0.2441061130334487, 0.5578316032295271, 0.768888888888889, 1.0),
    (0.11172625913110343, 0.42049980776624374, 0.6921184159938486, 1.0),
    (0.03137254901960784, 0.2897347174163783, 0.570319108035371, 1.0),
]
UNTRAINED_COLOR = "#AAAAAA"
BASELINE_COLOR = "#FFA500"
BAR_WIDTH = 0.72


def coarseness_colors(n: int | None = None) -> list:
    import matplotlib.pyplot as plt

    n = n or (N_COARSE + 1)
    cmap = plt.get_cmap("Blues")
    return [cmap(0.25 + 0.7 * i / max(n - 1, 1)) for i in range(n)]


def apply_style(ax, ylabel: str = "", title: str = ""):
    ax.spines["top"].set_visible(False)
    ax.spines["right"].set_visible(False)
    ax.set_ylabel(ylabel, fontsize=11)
    if title:
        ax.set_title(title, fontsize=12)
    ax.tick_params(labelsize=10)


def save_figure(fig, out_path: str, dpi: int = 200):
    import matplotlib.pyplot as plt

    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=dpi)
    plt.close(fig)
    print(f"Saved {out_path}")


# ── layout ───────────────────────────────────────────────────────────

def make_figure(dcfg: dict):
    """Figure, ordered axes and scale, honouring an optional (rows, cols,
    positions) layout (e.g. NSD's fine-grained (2, 4) grid)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n_regions = len(dcfg["regions"])
    layout = dcfg.get("layout")
    if layout:
        nrows, ncols, positions = layout
        scale = 1 + 0.25 * (ncols - 1)
        fig, grid = plt.subplots(nrows, ncols, figsize=(5 * ncols, 4.5 * nrows), squeeze=False)
        ax_list = [grid[r, c] for r, c in positions]
        used = set(tuple(p) for p in positions)
        for r in range(nrows):
            for c in range(ncols):
                if (r, c) not in used:
                    grid[r, c].set_visible(False)
    else:
        scale = 1 + 0.35 * (n_regions - 1)
        fig, grid = plt.subplots(1, n_regions, figsize=(5 * n_regions, 4 * scale),
                                 squeeze=False)
        ax_list = [grid[0, i] for i in range(n_regions)]
    return fig, ax_list, scale


# ── drawing primitives ───────────────────────────────────────────────

def draw_fancy_bar(ax, x, height, color, hatch: str = "", width: float = BAR_WIDTH,
                   scale: float = 1.0):
    ax.bar(x, height, width=width, color=color, edgecolor="black",
           linewidth=0.8 * scale, hatch=hatch, zorder=3)


def draw_break_marks(ax, x, scale: float = 1.0):
    """Diagonal slashes on the bottom spine at the x-axis break between
    the coarse granularities and the 1000-class baseline."""
    import matplotlib.transforms as mtransforms

    trans = mtransforms.blended_transform_factory(ax.transData, ax.transAxes)
    spine_y, dy, dx, gap = -0.022, 0.028, 0.20, 0.13
    ax.plot([x - gap - dx - 0.1, x + gap + dx + 0.1], [spine_y, spine_y],
            color="white", linewidth=5 * scale, transform=trans, clip_on=False, zorder=9)
    for off in (-gap, gap):
        ax.plot([x + off - dx, x + off + dx], [spine_y - dy, spine_y + dy],
                color="black", linewidth=1.8 * scale, transform=trans,
                clip_on=False, zorder=10)


def bar_with_ci(ax, xs, means, ci_lows, ci_highs, colors=None, hatch=None, width=0.7):
    """A labelled bar row with asymmetric CI whiskers."""
    colors = colors or coarseness_colors(len(xs))
    yerr = np.maximum(np.stack([
        np.asarray(means) - np.asarray(ci_lows),
        np.asarray(ci_highs) - np.asarray(means),
    ]), 0.0)
    bars = ax.bar(range(len(xs)), means, width=width, color=colors,
                  edgecolor="black", linewidth=0.6, hatch=hatch,
                  yerr=yerr, capsize=3, error_kw={"linewidth": 1.0})
    ax.set_xticks(range(len(xs)))
    ax.set_xticklabels([str(x) for x in xs])
    return bars


def _labels(dcfg: dict, pca_model: str, dataset_label):
    method = dcfg.get("compare_method", "spearman")
    analysis = dcfg.get("analysis", "rsa")
    return {"y_label": "Pearson r" if method == "pearson" else "Spearman ρ",
            "display": PCA_MODELS.get(pca_model, pca_model),
            "dataset_label": dataset_label or dcfg["neural_dataset"].upper(),
            "analysis_label": "Encoding Score" if analysis == "encoding_score" else "RSA"}


# ── figure 1: coarseness bars ────────────────────────────────────────

def coarseness_bars_data(dcfg: dict, pca_model: str, db_path=None) -> list:
    """Per region: the bars' x, mean, CI, colour, hatch and label (the
    untrained bar only where its rows exist)."""
    folder = f"pca_labels_{pca_model}"
    nd = dcfg["neural_dataset"]
    analysis = dcfg.get("analysis", "rsa")
    method = dcfg.get("compare_method", "spearman")
    epoch = dcfg.get("epoch", 20)
    panels = []
    for region in dcfg["regions"]:
        un = get_condition_summary(nd, region, "imagenet1k", FULL_CFG, method,
                                   epoch=0, analysis=analysis, db_path=db_path)
        has_untrained = not np.isnan(un["mean"])
        p = {"region": region, "x": [], "mean": [], "ci_low": [], "ci_high": [],
             "color": [], "hatch": [], "label": []}

        def add(x, s, color, hatch, label):
            p["x"].append(float(x))
            p["mean"].append(s["mean"])
            p["ci_low"].append(s["ci_low"])
            p["ci_high"].append(s["ci_high"])
            p["color"].append(color)
            p["hatch"].append(hatch)
            p["label"].append(label)

        if has_untrained:
            add(0.0, un, UNTRAINED_COLOR, "", "Untrained")
            x_coarse = np.arange(1.5, 1.5 + N_COARSE)
        else:
            x_coarse = np.arange(N_COARSE, dtype=float)
        for i, cfg_id in enumerate(COARSE_CFGS):
            add(x_coarse[i], get_condition_summary(nd, region, folder, cfg_id, method,
                                                   epoch=epoch, analysis=analysis,
                                                   db_path=db_path),
                BLUES[i], "/", str(cfg_id))
        x_base = x_coarse[-1] + 2
        add(x_base, get_condition_summary(nd, region, "imagenet1k", FULL_CFG, method,
                                          epoch=epoch, analysis=analysis, db_path=db_path),
            BASELINE_COLOR, "", "1000")
        p["break_x"] = float((x_coarse[-1] + x_base) / 2)
        panels.append(p)
    return panels


def _draw_coarseness_bars(panels: list, dcfg: dict, titles: dict, out: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.ticker import AutoMinorLocator

    plt.rcParams["hatch.color"] = "grey"
    fig, ax_list, scale = make_figure(dcfg)
    for ax, p in zip(ax_list, panels):
        xs, means = np.asarray(p["x"]), np.asarray(p["mean"], float)
        lo, hi = np.asarray(p["ci_low"], float), np.asarray(p["ci_high"], float)
        x_base = xs[-1]
        for k in range(len(xs)):
            if not np.isnan(means[k]):
                draw_fancy_bar(ax, xs[k], means[k], p["color"][k], p["hatch"][k], scale=scale)
            el, eh = means[k] - lo[k], hi[k] - means[k]
            if np.isfinite(el) and np.isfinite(eh) and el >= 0 and eh >= 0 and (el or eh):
                ax.errorbar(xs[k], means[k], yerr=[[el], [eh]], fmt="none",
                            ecolor="black", elinewidth=1.0 * scale,
                            capsize=4 * scale, capthick=1.0 * scale, zorder=5)
        draw_break_marks(ax, p["break_x"], scale=scale)
        finite_lo = lo[np.isfinite(lo)]
        finite_hi = hi[np.isfinite(hi)]
        vlo = finite_lo.min() if finite_lo.size else np.nanmin(means)
        vhi = finite_hi.max() if finite_hi.size else np.nanmax(means)
        dr = max(vhi - vlo, 0.01)
        ax.set_ylim(max(0, vlo - 0.2 * dr), vhi + 0.2 * dr)
        ax.set_xticks(xs)
        ax.set_xticklabels(p["label"], fontsize=10 * scale)
        ax.tick_params(axis="x", bottom=False)
        ax.yaxis.set_minor_locator(AutoMinorLocator(2))
        ax.set_xlim(xs[0] - 0.6, x_base + 0.7)
        ax.set_xlabel("Number of Classes", fontsize=13 * scale)
        ax.set_ylabel(titles["y_label"], fontsize=13 * scale)
        ax.set_title(dcfg.get("region_labels", {}).get(p["region"], p["region"]),
                     fontsize=15 * scale, fontweight="bold", pad=10 * scale)
        ax.spines["top"].set_visible(False)
        ax.spines["right"].set_visible(False)
    fig.suptitle(
        f"Brain Alignment Across Label Granularity\n"
        f"({titles['display']}-PCA Labels, {titles['dataset_label']} "
        f"{titles['analysis_label']})",
        fontsize=16 * scale, fontweight="bold", y=1.02,
    )
    plt.tight_layout(pad=1.0)
    fig.savefig(out, dpi=200, bbox_inches="tight", facecolor="white")
    plt.close(fig)
    print(f"Saved -> {out}")


def plot_coarseness_bars(dcfg: dict, pca_model: str, output_dir: str,
                         dataset_label: str | None = None, db_path=None) -> str:
    """Figure 1: its panels' series as JSON, then the figure."""
    titles = _labels(dcfg, pca_model, dataset_label)
    out = (f"{output_dir}/coarseness_bars_{titles['display'].lower()}"
           f"{dcfg.get('output_suffix', '')}.png")
    panels = coarseness_bars_data(dcfg, pca_model, db_path)
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    write_series(out, panels)
    draw_or_report(PROG, out, _draw_coarseness_bars, panels, dcfg, titles, out)
    return out


# ── figure 2: per-subject boxes ──────────────────────────────────────

def per_subject_data(dcfg: dict, pca_model: str, db_path=None) -> list:
    """Per region: the class-count labels with rows, their x positions,
    the subjects common to all of them and each label's per-subject
    scores (seed means) on those subjects; ``insufficient`` where fewer
    than two labels have rows."""
    folder = f"pca_labels_{pca_model}"
    nd = dcfg["neural_dataset"]
    analysis = dcfg.get("analysis", "rsa")
    method = dcfg.get("compare_method", "spearman")
    epoch = dcfg.get("epoch", 20)
    panels = []
    for region in dcfg["regions"]:
        data, x_labels = {}, []
        for n_classes in COARSE_CFGS:
            sm = get_subject_scores(nd, region, folder, n_classes, method,
                                    epoch=epoch, analysis=analysis, db_path=db_path)
            if len(sm):
                data[str(n_classes)] = sm
                x_labels.append(str(n_classes))
        sm_1k = get_subject_scores(nd, region, "imagenet1k", FULL_CFG, method,
                                   epoch=epoch, analysis=analysis, db_path=db_path)
        if len(sm_1k):
            data["1K"] = sm_1k
            x_labels.append("1K")
        if len(x_labels) < 2:
            panels.append({"region": region, "insufficient": True})
            continue
        common = sorted(set.intersection(*(set(data[lab]) for lab in x_labels)))
        n_coarse = sum(1 for lab in x_labels if lab != "1K")
        panels.append({
            "region": region, "insufficient": False, "labels": x_labels,
            "x": [n_coarse + 0.7 if lab == "1K" else float(i) for i, lab in enumerate(x_labels)],
            "subjects": common,
            "scores": [[data[lab][s] for s in common] for lab in x_labels]})
    return panels


def _draw_per_subject(panels: list, dcfg: dict, titles: dict, out: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax_list, scale = make_figure(dcfg)
    for ax, p in zip(ax_list, panels):
        if p["insufficient"]:
            ax.text(0.5, 0.5, "Insufficient data", ha="center", va="center",
                    transform=ax.transAxes, color="gray")
            continue
        x_labels, x_pos = p["labels"], np.asarray(p["x"])
        colors = ["#7f7f7f" if lab == "1K" else BLUES[COARSE_CFGS.index(int(lab))]
                  for lab in x_labels]
        box_data = [np.asarray(s, float) for s in p["scores"]]
        bp = ax.boxplot(box_data, positions=x_pos, patch_artist=True, widths=0.5,
                        medianprops=dict(linewidth=1.5 * scale, color="black"),
                        flierprops=dict(marker="o", markersize=3 * scale, alpha=0.5))
        for patch, c in zip(bp["boxes"], colors):
            patch.set_facecolor(c)
            patch.set_alpha(0.7)
            patch.set_edgecolor("black")
        for j in range(len(p["subjects"])):
            ax.plot(x_pos, [s[j] for s in box_data], color="gray",
                    alpha=0.25, linewidth=0.8 * scale, zorder=1)
        jitter = np.random.default_rng(42)
        for i, y in enumerate(box_data):
            ax.scatter(jitter.normal(x_pos[i], 0.06, len(y)), y, s=25 * scale,
                       c="white", edgecolors="black", linewidths=0.7 * scale,
                       zorder=3, alpha=0.9)
        ax.set_xticks(x_pos)
        ax.set_xticklabels(x_labels, fontweight="bold", fontsize=11 * scale)
        ax.set_xlabel("Number of Classes", fontsize=13 * scale)
        ax.set_ylabel(titles["y_label"], fontsize=13 * scale)
        ax.set_title(dcfg.get("region_labels", {}).get(p["region"], p["region"]),
                     fontsize=15 * scale, fontweight="bold")
        all_vals = np.concatenate(box_data)
        yr = max(all_vals.max() - all_vals.min(), 1e-6)
        ax.set_ylim(all_vals.min() - 0.05 * yr, all_vals.max() + 0.15 * yr)
        ax.yaxis.grid(True, alpha=0.3, linewidth=0.5 * scale)
        ax.set_axisbelow(True)
        ax.set_xlim(-0.5, x_pos[-1] + 0.5)
        ax.spines["top"].set_visible(False)
        ax.spines["right"].set_visible(False)
    fig.suptitle(
        f"Per-Subject Brain Alignment\n"
        f"({titles['display']}-PCA Labels, {titles['dataset_label']} "
        f"{titles['analysis_label']})",
        fontsize=16 * scale, fontweight="bold", y=1.02,
    )
    plt.tight_layout(pad=1.0)
    fig.savefig(out, dpi=200, bbox_inches="tight", facecolor="white")
    plt.close(fig)
    print(f"Saved -> {out}")


def plot_per_subject(dcfg: dict, pca_model: str, output_dir: str,
                     dataset_label: str | None = None, db_path=None) -> str | None:
    """Figure 2: its panels' series as JSON, then the figure; None for a
    dataset without subjects."""
    if not dcfg.get("has_subjects", True):
        print(f"Skipping per-subject plot ({dcfg['neural_dataset']} has no subjects)")
        return None
    titles = _labels(dcfg, pca_model, dataset_label)
    out = (f"{output_dir}/per_subject_{titles['display'].lower()}"
           f"{dcfg.get('output_suffix', '')}.png")
    panels = per_subject_data(dcfg, pca_model, db_path)
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    write_series(out, panels)
    draw_or_report(PROG, out, _draw_per_subject, panels, dcfg, titles, out)
    return out
