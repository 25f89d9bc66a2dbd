"""Dimensionality comparison figures (port of
``experiments/representation_analysis/dim_plots.py``): metric
trajectories with ratio and grouped bars, eigenspectra, sparsity, and the
text summary table. matplotlib is imported by each drawing function when
it is called; ``print_summary_table`` needs none.
"""
from __future__ import annotations

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


PALETTE = ("#2066a8", "#d47264")  # model A / model B


def _axis(ax, xlabel, ylabel, title):
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title, fontweight="bold")
    ax.spines[["top", "right"]].set_visible(False)


def plot_metric_comparison(results, layers, model_names, ylabel, title, out_path):
    """Three-panel layer comparison: trajectories, ratio bars, grouped bars.

    results: {model_name: {layer: value}}.
    """
    plt = _pyplot()
    fig, (ax_line, ax_ratio, ax_bars) = plt.subplots(1, 3, figsize=(15, 4.5))
    x = np.arange(len(layers))
    vals = {m: np.array([float(results[m][l]) for l in layers]) for m in model_names}

    for m, color in zip(model_names, PALETTE):
        ax_line.plot(x, vals[m], "o-", color=color, label=m, linewidth=2)
    ax_line.set_xticks(x, layers)
    ax_line.legend(frameon=False)
    _axis(ax_line, "Layer", ylabel, title)

    ratio = vals[model_names[0]] / np.maximum(vals[model_names[1]], 1e-10)
    ax_ratio.bar(x, ratio, color=np.where(ratio > 1, "#4a7c59", "#b3453e"))
    for xi, r in zip(x, ratio):
        ax_ratio.annotate(f"{r:.2f}x", (xi, r), ha="center", va="bottom", fontsize=8)
    ax_ratio.axhline(1.0, color="black", linestyle="--", linewidth=1)
    ax_ratio.set_xticks(x, layers)
    _axis(ax_ratio, "Layer", f"{model_names[0]} / {model_names[1]}", "Ratio")

    w = 0.38
    for i, (m, color) in enumerate(zip(model_names, PALETTE)):
        ax_bars.bar(x + (i - 0.5) * w, vals[m], w, color=color, label=m)
    ax_bars.set_xticks(x, layers)
    ax_bars.legend(frameon=False)
    _axis(ax_bars, "Layer", ylabel, "Side by side")

    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def plot_eigenspectrum(eigs_dict, layers_to_plot, model_names, out_path,
                       n_components: int = 100):
    """Log-scale normalized eigenspectra, one panel per layer.

    eigs_dict: {model_name: {layer: eigenvalues (descending)}}.
    """
    plt = _pyplot()
    fig, axes = plt.subplots(1, len(layers_to_plot),
                             figsize=(5 * len(layers_to_plot), 4), squeeze=False)
    for ax, layer in zip(axes[0], layers_to_plot):
        for m, color in zip(model_names, PALETTE):
            eigs = np.asarray(eigs_dict[m][layer])
            k = min(n_components, len(eigs))
            ax.plot(np.arange(1, k + 1), eigs[:k] / max(eigs[0], 1e-30),
                    color=color, label=m, linewidth=2)
        ax.set_yscale("log")
        ax.legend(frameon=False, fontsize=9)
        _axis(ax, "Component", "Normalized eigenvalue", f"{layer} eigenspectrum")
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def plot_sparsity_comparison(sparsity_results, layers, model_names, out_path):
    """Hoyer-sparsity trajectories (±1 SD) and per-layer difference.

    sparsity_results: {model_name: {layer: {"mean": m, "std": s}}}.
    """
    plt = _pyplot()
    fig, (ax_traj, ax_diff) = plt.subplots(1, 2, figsize=(13, 4.5))
    x = np.arange(len(layers))
    means = {m: np.array([sparsity_results[m][l]["mean"] for l in layers])
             for m in model_names}
    stds = {m: np.array([sparsity_results[m][l]["std"] for l in layers])
            for m in model_names}

    for m, color in zip(model_names, PALETTE):
        ax_traj.errorbar(x, means[m], yerr=stds[m], fmt="o-", color=color,
                         label=m, capsize=3, linewidth=2)
    ax_traj.set_xticks(x, layers)
    ax_traj.set_ylim(0, 1)
    ax_traj.legend(frameon=False)
    _axis(ax_traj, "Layer", "Hoyer sparsity", "Activation sparsity (0=dense, 1=sparse)")

    diff = means[model_names[1]] - means[model_names[0]]
    ax_diff.bar(x, diff, color=np.where(diff > 0, "#4a7c59", "#b3453e"))
    for xi, d in zip(x, diff):
        ax_diff.annotate(f"{d:+.3f}", (xi, d), ha="center",
                         va="bottom" if d >= 0 else "top", fontsize=8)
    ax_diff.axhline(0.0, color="black", linewidth=1)
    ax_diff.set_xticks(x, layers)
    _axis(ax_diff, "Layer", f"{model_names[1]} − {model_names[0]}", "Sparsity change")

    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def print_summary_table(results, layers, model_names):
    """Text summary: one block per metric, rows = layers, plus ratios.

    results: {metric_name: {model_name: {layer: value-or-dict}}}.
    """
    print("\n" + "=" * 72)
    print("DIMENSIONALITY ANALYSIS SUMMARY")
    print("=" * 72)
    for metric_name, per_model in results.items():
        print(f"\n{metric_name}")
        print("-" * 56)
        print(f"{'layer':<10}" + "".join(f"{m[:16]:>18}" for m in model_names)
              + f"{'ratio':>10}")
        for layer in layers:
            vals = []
            for m in model_names:
                v = per_model[m][layer]
                if isinstance(v, dict):
                    v = v.get("mean", v.get("dimension", 0.0))
                vals.append(float(v))
            row = f"{layer:<10}" + "".join(f"{v:>18.2f}" for v in vals)
            if len(vals) == 2 and vals[1]:
                row += f"{vals[0] / vals[1]:>9.2f}x"
            print(row)
