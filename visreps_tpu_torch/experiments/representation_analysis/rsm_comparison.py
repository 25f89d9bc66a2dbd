"""Cross-model RDM comparison over a shared stimulus set (port of
``experiments/representation_analysis/rsm_comparison.py``).

Each model's taps (pre and post, SRP k = 4096, the float32 store) over a
folder of images, one correlation RDM per tap through ``ops/rdm.compute_rdm``
(one launch of the Hopper RDM kernel per tap on the card), then the
Spearman (or ``--compare-method``) similarity of every pair of RDMs,
saved as the JAX script saves it (``similarity``, ``names``).

Usage:
  python -m visreps_tpu_torch.experiments.representation_analysis.rsm_comparison \\
      --stimuli-dir IMAGES --models AlexNet ResNet18 [--layers-per-model 3] \\
      --out rsm_cmp.npz [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.device import resolve_device
from visreps_tpu_torch.experiments.representation_analysis.dimensionality import folder_stimuli
from visreps_tpu_torch.ops.rdm import compute_rdm, compute_rdm_correlation


def collect_rdms(model_name: str, stimuli: dict, batch_size: int,
                 max_layers: int | None, pretrained: str, device=None) -> dict:
    """{"<model>/<tap>": (n, n) float32 RDM on the device} of one model
    (seed-0 init, IMAGENET1K weights with ``pretrained="imagenet1k"``)."""
    from visreps_tpu_torch.data.loader import make_stimuli_loader
    from visreps_tpu_torch.data.transforms import get_transform
    from visreps_tpu_torch.models.extractor import FeatureExtractor
    from visreps_tpu_torch.models.zoo import TORCHVISION_RETURN_NODES, init_model

    model = init_model(model_name, 1000, seed=0, device=device)
    if pretrained == "imagenet1k":
        from visreps_tpu_torch.models.torch_import import load_pretrained_torch

        model = load_pretrained_torch(model, model_name, 1000)
    nodes = TORCHVISION_RETURN_NODES[model_name]
    if max_layers:
        step = max(1, len(nodes) // max_layers)
        nodes = nodes[::step][:max_layers]
    extractor = FeatureExtractor(model, nodes, srp_k=4096, image_size=224, device=device)
    loader = make_stimuli_loader(stimuli, get_transform("imgnet"), batch_size)
    acts, _ = extractor.get_activations(loader, store="host")
    return {f"{model_name}/{layer}": compute_rdm(a.to(extractor.device))
            for layer, a in acts.items()}


def similarity_matrix(rdms: dict, compare_method: str = "spearman") -> np.ndarray:
    """(m, m) correlations of every pair of the RDMs' upper triangles."""
    names = list(rdms)
    sim = np.zeros((len(names), len(names)))
    for a in range(len(names)):
        for b in range(a, len(names)):
            s = compute_rdm_correlation(rdms[names[a]], rdms[names[b]],
                                        correlation=compare_method)
            sim[a, b] = sim[b, a] = s
    return sim


def main(argv=None):
    """Returns ({name: RDM tensor}, similarity matrix)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--stimuli-dir", required=True)
    parser.add_argument("--models", nargs="+", default=["AlexNet", "ResNet18"])
    parser.add_argument("--pretrained", default="none", choices=["none", "imagenet1k"])
    parser.add_argument("--layers-per-model", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--compare-method", default="spearman")
    parser.add_argument("--out", default="rsm_comparison.npz")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    stimuli = folder_stimuli(args.stimuli_dir)
    rprint(f"{len(stimuli)} stimuli", style="info")

    rdms: dict = {}
    for model in args.models:
        rprint(f"Extracting {model}...", style="setup")
        rdms.update(collect_rdms(model, stimuli, args.batch_size,
                                 args.layers_per_model, args.pretrained, device))

    sim = similarity_matrix(rdms, args.compare_method)
    np.savez(args.out, similarity=sim, names=np.asarray(list(rdms)))
    rprint(f"Saved {args.out} ({len(rdms)} x {len(rdms)})", style="success")
    return rdms, sim


if __name__ == "__main__":
    main()
