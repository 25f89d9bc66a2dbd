"""Alignment of activations with neural targets (port of
``visreps_tpu/analysis/alignment.py``): the AlignmentData bundle,
ID-based alignment, train/test preparation, THINGS concept averaging and
the per-pair analysis dispatch (RSA or encoding). Activation stores are
indexed where they live, so a device store stays on the device.
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


def take_rows(a, idx: np.ndarray):
    """Rows ``idx`` of an array, or of a tensor on its own device."""
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
    return {l: take_rows(a, idx) for l, a in acts_raw.items()}, neural, matched_ids


def prepare_traintest_alignment(cfg, acts_raw, neural_data_raw, keys):
    """(train, test) AlignmentData for stimulus-level datasets."""
    train_acts, train_neural, train_ids = align_stimulus_level(acts_raw, neural_data_raw["train"], keys)
    test_acts, test_neural, test_ids = align_stimulus_level(acts_raw, neural_data_raw["test"], keys)
    train = AlignmentData(train_acts, train_neural, stimulus_ids=train_ids)
    test = AlignmentData(test_acts, test_neural, stimulus_ids=test_ids)
    logger.info("Prepared train/test alignment: %d train, %d test samples.",
                train.neural.shape[0], test.neural.shape[0])
    return train, test


def prepare_concept_alignment(cfg, acts_raw, neural_data_raw, keys) -> AlignmentData:
    """Average activations per THINGS concept and pair them with the
    concepts' embeddings.

    ``neural_data_raw`` holds "embeddings" {concept: vector} and
    "image_ids" {concept: [image ids]}; a concept none of whose images
    is among ``keys`` is dropped. Tensors (a store on the card, or the
    host store's CPU tensors) are averaged where they lie, in float32,
    as one segment mean per tap (``index_add_`` into G + 1 rows; row G
    collects images of no concept); numpy arrays are averaged concept by
    concept in float32 and keep their dtype.
    """
    key_to_idx = {str(k): i for i, k in enumerate(keys)}
    embeddings = neural_data_raw["embeddings"]
    concepts: List[str] = []
    concept_image_ids: Dict[str, List[str]] = {}
    for concept, img_ids in neural_data_raw["image_ids"].items():
        matched = [sid for sid in img_ids if sid in key_to_idx]
        if matched:
            concepts.append(concept)
            concept_image_ids[concept] = matched

    if acts_raw and isinstance(next(iter(acts_raw.values())), torch.Tensor):
        n_stimuli = next(iter(acts_raw.values())).shape[0]
        seg = np.full(n_stimuli, len(concepts), np.int64)
        counts = np.zeros(len(concepts), np.float32)
        for gi, c in enumerate(concepts):
            seg[[key_to_idx[sid] for sid in concept_image_ids[c]]] = gi
            counts[gi] = len(concept_image_ids[c])
        acts = {}
        for layer, a in acts_raw.items():
            seg_t = torch.as_tensor(seg, device=a.device)
            sums = torch.zeros((len(concepts) + 1, a.shape[1]), dtype=torch.float32,
                               device=a.device).index_add_(0, seg_t, a.to(torch.float32))
            acts[layer] = sums[:-1] / torch.as_tensor(counts, device=a.device)[:, None]
    else:
        acts = {}
        for layer, a in acts_raw.items():
            a = np.asarray(a)
            acts[layer] = np.stack([
                a[[key_to_idx[sid] for sid in concept_image_ids[c]]].astype(np.float32).mean(axis=0)
                for c in concepts]).astype(a.dtype)

    neural = np.stack([np.asarray(embeddings[c], np.float32) for c in concepts])
    logger.info("Prepared concept alignment: %d concepts.", len(concepts))
    return AlignmentData(acts, neural, stimulus_ids=concepts, concept_image_ids=concept_image_ids)


def compute_traintest_alignment(cfg, train: AlignmentData, test: AlignmentData,
                                verbose: bool = False, re_extract_fn=None,
                                device=None, mesh=None) -> List[dict]:
    """Per-pair dispatch on ``cfg.analysis``: ``compute_rsa`` (with
    ``re_extract_fn`` for the selected layer's full-resolution test
    activations; its bootstrap sharded over ``mesh``) or the encoding
    score."""
    from visreps_tpu_torch.analysis.encoding import compute_encoding_score
    from visreps_tpu_torch.analysis.rsa import compute_rsa

    analysis = cfg.get("analysis", "rsa").lower()
    bootstrap = cfg.get("bootstrap", True)
    n_bootstrap = cfg.get("n_bootstrap", 1000)
    if analysis == "encoding_score" and cfg.get("neural_dataset", "").lower() == "things-behavior":
        raise ValueError(
            "Encoding score is not supported for things-behavior (behavioral embeddings "
            "have no voxels to predict). Use analysis=rsa instead.")
    if analysis == "rsa":
        return compute_rsa(cfg, train, test, n_select=cfg.get("n_select", None),
                           bootstrap=bootstrap, n_bootstrap=n_bootstrap, verbose=verbose,
                           re_extract_fn=re_extract_fn, device=device, mesh=mesh)
    if analysis == "encoding_score":
        pca_k = cfg.get("pca_k", 1) if cfg.get("reconstruct_from_pcs") else None
        return compute_encoding_score(
            train, test, bootstrap=bootstrap, n_bootstrap=n_bootstrap, verbose=verbose,
            reconstruct_pca_k=pca_k, device=device)
    raise ValueError(f"Unknown analysis method: {analysis}")
