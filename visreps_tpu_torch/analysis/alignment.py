"""Stimulus-level alignment of activations with neural targets (port of
``visreps_tpu/analysis/alignment.py:20-57, 128-158``): the AlignmentData
bundle, ID-based alignment, train/test preparation and the per-pair
analysis dispatch. Activation stores are indexed where they live, so a
device store stays on the device.

Concept averaging (``prepare_concept_alignment``) and the per-pair RSA
branch wait for ROADMAP.md's "THINGS/TVSD/NSD-synthetic" item.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


@dataclass
class AlignmentData:
    """Bundled activations and neural data for one split."""

    activations: Dict[str, Any]  # {layer: (n_stimuli, features) tensor or array}
    neural: np.ndarray           # (n_stimuli, n_voxels)
    stimulus_ids: Optional[List[str]] = None
    concept_image_ids: Optional[Dict[str, List[str]]] = None


def _take_rows(a, idx: np.ndarray):
    if isinstance(a, torch.Tensor):
        return a[torch.as_tensor(idx, dtype=torch.long, device=a.device)]
    return a[idx]


def align_stimulus_level(acts_raw: Dict[str, Any], targets: Dict[str, Any], keys):
    """Align activations with neural targets by stimulus ID.
    Returns (acts, neural, matched_ids)."""
    idx = [i for i, k in enumerate(keys) if str(k) in targets]
    matched_ids = [str(keys[i]) for i in idx]
    if not matched_ids:
        return {l: a[:0] for l, a in acts_raw.items()}, np.empty((0,), np.float32), matched_ids
    neural = np.stack([np.asarray(targets[sid], np.float32) for sid in matched_ids])
    if neural.ndim > 2:
        neural = neural.squeeze()
    idx = np.asarray(idx)
    return {l: _take_rows(a, idx) for l, a in acts_raw.items()}, neural, matched_ids


def prepare_traintest_alignment(cfg, acts_raw, neural_data_raw, keys):
    """(train, test) AlignmentData for stimulus-level datasets."""
    train_acts, train_neural, train_ids = align_stimulus_level(acts_raw, neural_data_raw["train"], keys)
    test_acts, test_neural, test_ids = align_stimulus_level(acts_raw, neural_data_raw["test"], keys)
    train = AlignmentData(train_acts, train_neural, stimulus_ids=train_ids)
    test = AlignmentData(test_acts, test_neural, stimulus_ids=test_ids)
    logger.info("Prepared train/test alignment: %d train, %d test samples.",
                train.neural.shape[0], test.neural.shape[0])
    return train, test


def compute_traintest_alignment(cfg, train: AlignmentData, test: AlignmentData,
                                verbose: bool = False, device=None) -> List[dict]:
    """Per-pair dispatch on ``cfg.analysis``: the encoding score (the RSA
    branch is not ported yet)."""
    from visreps_tpu_torch.analysis.encoding import compute_encoding_score

    analysis = cfg.get("analysis", "rsa").lower()
    if analysis == "encoding_score" and cfg.get("neural_dataset", "").lower() == "things-behavior":
        raise ValueError(
            "Encoding score is not supported for things-behavior (behavioral embeddings "
            "have no voxels to predict). Use analysis=rsa instead.")
    if analysis == "rsa":
        raise NotImplementedError(
            "per-pair compute_rsa is not ported yet (ROADMAP.md, 'THINGS/TVSD/NSD-synthetic')")
    if analysis == "encoding_score":
        pca_k = cfg.get("pca_k", 1) if cfg.get("reconstruct_from_pcs") else None
        return compute_encoding_score(
            train, test, bootstrap=cfg.get("bootstrap", True),
            n_bootstrap=cfg.get("n_bootstrap", 1000), verbose=verbose,
            reconstruct_pca_k=pca_k, device=device)
    raise ValueError(f"Unknown analysis method: {analysis}")
