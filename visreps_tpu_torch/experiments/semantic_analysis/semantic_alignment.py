"""Semantic alignment: model representations against caption embeddings
(port of ``experiments/semantic_analysis/semantic_alignment.py``).

Each tap's RSA score against the RDM of per-stimulus caption-embedding
vectors (an npz of ``stimulus_ids`` and ``gemini_representations``)
instead of voxel responses: stimulus-level alignment
(``analysis/alignment``), one RDM of the embeddings and one per tap
(``ops/rdm.compute_rdm``: one launch of the Hopper RDM kernel each on
the card), optionally after ``reconstruct_from_pcs``, then
``compute_rdm_correlation``; rows saved to results.db when
``log_expdata`` is set. As the JAX docstring notes, the reference
script's own imports never existed; this follows the JAX package.

Usage:
  python -m visreps_tpu_torch.experiments.semantic_analysis.semantic_alignment \\
      --config configs/eval/base.json --override neural_dataset=nsd \\
      gemini_features_path=emb.npz log_expdata=true [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from visreps_tpu_torch.analysis.alignment import align_stimulus_level
from visreps_tpu_torch.core.config import Config
from visreps_tpu_torch.core.db import save_results
from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.device import resolve_device
from visreps_tpu_torch.ops.pca import reconstruct_from_pcs
from visreps_tpu_torch.ops.rdm import compute_rdm, compute_rdm_correlation


def load_embeddings(path: str) -> dict:
    """{stimulus_id: embedding} from the caption-embedding npz."""
    data = np.load(path, allow_pickle=True)
    return {
        str(sid): emb
        for sid, emb in zip(data["stimulus_ids"], data["gemini_representations"])
    }


def semantic_alignment_scores(cfg, acts: dict, embeddings: dict, ids, device=None) -> list:
    """Per-tap RSA score against the embedding RDM, on ``device`` (default:
    where the activations lie; arrays need ``device``)."""
    acts_aligned, emb_aligned, _ = align_stimulus_level(acts, embeddings, ids)
    if device is None:
        first = next(iter(acts_aligned.values()))
        if not isinstance(first, torch.Tensor):
            raise ValueError("pass device= for array activations")
        device = first.device
    device = resolve_device(device)
    method = cfg.get("compare_method", "spearman")
    emb_rdm = compute_rdm(torch.as_tensor(np.asarray(emb_aligned, np.float32)).to(device))
    rows = []
    for layer, a in acts_aligned.items():
        a = torch.as_tensor(a).to(device, torch.float32)
        if cfg.get("reconstruct_from_pcs"):
            a = reconstruct_from_pcs({layer: a}, cfg.pca_k)[layer]
        score = float(compute_rdm_correlation(compute_rdm(a), emb_rdm, method))
        rows.append({
            "layer": layer, "score": score, "compare_method": method,
            "analysis": "semantic_alignment",
            "region": "N/A", "subject_idx": "N/A",
        })
        rprint(f"  {layer}: {score:.4f}", style="info")
    return rows


def eval(cfg: Config, device=None):
    """Model, taps of the neural dataset's stimuli (the float32 store),
    scores; rows saved when ``log_expdata`` is set. Returns the rows."""
    from visreps_tpu_torch.data.neural import get_neural_loader
    from visreps_tpu_torch.models.extractor import configure_feature_extractor
    from visreps_tpu_torch.models.zoo import load_model

    device = resolve_device(device)
    rprint("\n[1/3] Model", style="info")
    model = load_model(cfg, device=device)
    extractor = configure_feature_extractor(cfg, model, device=device)

    rprint("\n[2/3] Embeddings + activations", style="info")
    emb_path = cfg.get("gemini_features_path",
                       "datasets/neural/nsd/gemini_representations.npz")
    embeddings = load_embeddings(emb_path)
    _, dl = get_neural_loader(cfg)
    acts, ids = extractor.get_activations(dl, store="host")

    rprint("\n[3/3] Alignment + save", style="info")
    rows = semantic_alignment_scores(cfg, acts, embeddings, ids, device=device)
    if cfg.get("log_expdata"):
        save_results(rows, cfg)
    return rows


def main(argv=None):
    from visreps_tpu_torch.core.config import load_config
    from visreps_tpu_torch.run import validate_config

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="configs/eval/base.json")
    parser.add_argument("--override", nargs="*", default=[])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    cfg = validate_config(load_config(args.config, args.override))
    return eval(cfg, device=args.device)


if __name__ == "__main__":
    main()
