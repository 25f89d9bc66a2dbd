"""Dimensionality analysis across layers (port of
``experiments/representation_analysis/dimensionality.py``).

A checkpoint's taps (pre and post, SRP k = 4096, the float32 store) over
a folder of images, then per layer the participation ratio, components
for 90 % variance, Two-NN intrinsic dimension (± bootstrap SE), Hoyer
sparsity (mean, std, fraction active) and the eigenspectrum, on the
device (``dim_metrics``), written as one CSV row per layer. With a second
checkpoint, the four comparison figures: each figure's data is written
as JSON beside it first, and the figure drawn only where matplotlib
imports.

Usage:
  python -m visreps_tpu_torch.experiments.representation_analysis.dimensionality \\
      --checkpoint-dir DIR --cfg-id 32 [--compare-cfg-id 1000] --stimuli-dir IMAGES \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import csv
import os

from visreps_tpu_torch.core.config import Config
from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.experiments.neurips_2025.figutils import draw_or_report, write_series
from visreps_tpu_torch.experiments.representation_analysis import dim_plots
from visreps_tpu_torch.experiments.representation_analysis.dim_metrics import (
    compute_all_metrics,
)

PROG = "representation_analysis.dimensionality"


def folder_stimuli(stimuli_dir: str) -> dict:
    """{file stem: path} of the JPEG and PNG files of a folder, sorted."""
    return {
        os.path.splitext(f)[0]: os.path.join(stimuli_dir, f)
        for f in sorted(os.listdir(stimuli_dir))
        if f.lower().endswith((".jpg", ".jpeg", ".png"))
    }


def _extract(args, cfg_id) -> dict:
    """{tap: (N, k) float32 tensor on the device} of one checkpoint."""
    from visreps_tpu_torch.data.loader import make_stimuli_loader
    from visreps_tpu_torch.data.transforms import get_transform
    from visreps_tpu_torch.models.extractor import configure_feature_extractor
    from visreps_tpu_torch.models.zoo import load_model

    cfg = Config({
        "load_model_from": "checkpoint", "seed": args.seed, "cfg_id": cfg_id,
        "checkpoint_dir": args.checkpoint_dir, "checkpoint_model": args.checkpoint_model,
        "return_nodes": args.return_nodes, "batchsize": args.batch_size,
    })
    model = load_model(cfg, device=args.device)
    extractor = configure_feature_extractor(cfg, model, device=args.device)
    loader = make_stimuli_loader(folder_stimuli(args.stimuli_dir), get_transform("imgnet"),
                                 args.batch_size)
    acts, _ = extractor.get_activations(loader, store="host")
    return {layer: a.to(extractor.device) for layer, a in acts.items()}


def write_csv(results, layers, out_path):
    """One row per layer with every scalar metric."""
    with open(out_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=[
            "layer", "participation_ratio", "n_components_90", "twonn_id",
            "twonn_se", "hoyer_sparsity_mean", "hoyer_sparsity_std",
            "fraction_active"])
        writer.writeheader()
        for layer in layers:
            writer.writerow({
                "layer": layer,
                "participation_ratio": round(results["pr"][layer], 3),
                "n_components_90": results["n90"][layer],
                "twonn_id": round(results["twonn"][layer]["dimension"], 3),
                "twonn_se": round(results["twonn"][layer]["std"], 3),
                "hoyer_sparsity_mean": round(results["sparsity"][layer]["mean"], 4),
                "hoyer_sparsity_std": round(results["sparsity"][layer]["std"], 4),
                "fraction_active": round(results["sparsity"][layer]["frac_active"], 4),
            })


def render_comparison(per_model, layers, model_names, out_dir, spectrum_layers=None):
    """The four comparison figures of two models' ``compute_all_metrics``
    results ({model name: result}): each one's data as JSON, then the
    figure where matplotlib imports; the summary table printed. Returns
    the figure paths."""
    os.makedirs(out_dir, exist_ok=True)
    a, b = model_names
    spectrum_layers = spectrum_layers or layers[: min(3, len(layers))]
    twonn = {m: {layer: per_model[m]["twonn"][layer]["dimension"] for layer in layers}
             for m in model_names}
    figures = [
        ("participation_ratio.png", dim_plots.plot_metric_comparison,
         ({a: per_model[a]["pr"], b: per_model[b]["pr"]}, layers, model_names,
          "Participation ratio", "Effective dimensionality (PR)")),
        ("intrinsic_dimension.png", dim_plots.plot_metric_comparison,
         (twonn, layers, model_names, "Intrinsic dimension",
          "Manifold dimensionality (Two-NN)")),
        ("eigenspectrum.png", dim_plots.plot_eigenspectrum,
         ({m: per_model[m]["eigenvalues"] for m in model_names}, spectrum_layers,
          model_names)),
        ("sparsity.png", dim_plots.plot_sparsity_comparison,
         ({m: per_model[m]["sparsity"] for m in model_names}, layers, model_names)),
    ]
    paths = []
    for name, draw, data in figures:
        path = os.path.join(out_dir, name)
        paths.append(path)
        write_series(path, {"layers": layers, "model_names": model_names, "data": data[0]})
        draw_or_report(PROG, path, draw, *data, path)

    dim_plots.print_summary_table({
        "Participation Ratio": {m: per_model[m]["pr"] for m in model_names},
        "Two-NN Dimension": twonn,
        "Components (90% var)": {m: per_model[m]["n90"] for m in model_names},
    }, layers, model_names)
    return paths


def main(argv=None):
    """Returns {"cfg<id>": compute_all_metrics result} of each checkpoint."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint-dir", required=True)
    parser.add_argument("--cfg-id", required=True)
    parser.add_argument("--compare-cfg-id", default=None,
                        help="second checkpoint for the comparison figures")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--checkpoint-model", default="checkpoint_epoch_20.pth")
    parser.add_argument("--stimuli-dir", required=True)
    parser.add_argument("--return-nodes", nargs="+",
                        default=["conv1", "conv2", "conv3", "conv4", "conv5", "fc1", "fc2"])
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--twonn-samples", type=int, default=2000)
    parser.add_argument("--out", default="dimensionality.csv")
    parser.add_argument("--fig-dir", default="dimensionality_figs")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    acts = _extract(args, args.cfg_id)
    layers = list(acts)
    results = compute_all_metrics(acts, layers, n_samples_twonn=args.twonn_samples)
    write_csv(results, layers, args.out)
    for layer in layers:
        rprint(f"{layer}: PR {results['pr'][layer]:.1f}, "
               f"n90 {results['n90'][layer]}, "
               f"Two-NN {results['twonn'][layer]['dimension']:.1f}, "
               f"sparsity {results['sparsity'][layer]['mean']:.3f}", style="info")
    rprint(f"Saved {args.out}", style="success")
    per_model = {f"cfg{args.cfg_id}": results}

    if args.compare_cfg_id:
        del acts
        acts_b = _extract(args, args.compare_cfg_id)
        results_b = compute_all_metrics(acts_b, layers, n_samples_twonn=args.twonn_samples)
        per_model[f"cfg{args.compare_cfg_id}"] = results_b
        render_comparison(per_model, layers, list(per_model), args.fig_dir)
        rprint(f"Saved comparison figures to {args.fig_dir}/", style="success")
    return per_model


if __name__ == "__main__":
    main()
