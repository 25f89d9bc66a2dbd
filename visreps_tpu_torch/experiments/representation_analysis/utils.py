"""Shared utilities of the representation analyses (port of
``experiments/representation_analysis/utils.py``): the experiments'
constants, pooled multi-tap extraction over a loader, feature npz and
label CSV readers, the 2-D embedding (umap, else sklearn t-SNE, both
imported only when called) and the model pair of the two-PC comparison.
"""
from __future__ import annotations

import csv
import os
from pathlib import Path

import numpy as np
import torch

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.device import resolve_device
from visreps_tpu_torch.models.pooling import make_pooled_extractor

DATASET = "imagenet-mini-50"
LAYER = "fc2"
ALL_LAYERS = ["conv1", "conv2", "conv3", "conv4", "conv5", "fc1", "fc2"]
MODEL_NAMES = ["Pretrained (1000-way)", "32-way Trained"]
OUTPUT_DIR = str(Path(__file__).resolve().parent)
SEED = 42


def extract_pooled_layers(model, loader, layers=None, pool_size: int | None = 3,
                          l2_normalize: bool = True, device=None):
    """({layer: (N, d) float32 array}, (N,) labels) over a loader of
    (batch, labels) with (B, H, W, 3) float32 batches, the model run on
    ``device`` (CUDA unless ``"cpu"`` is asked for)."""
    from visreps_tpu_torch.train.trainer import images_to_device

    device = resolve_device(device)
    layers = list(layers or ALL_LAYERS)
    step = make_pooled_extractor(model.to(device).eval(), layers, pool_size, l2_normalize)
    feats = {layer: [] for layer in layers}
    labels_all = []
    for x, y in loader:
        out = step(images_to_device(np.asarray(x), device))
        for layer in layers:
            feats[layer].append(out[layer].cpu())
        labels_all.extend(np.asarray(y).tolist())
    return ({layer: torch.cat(v).numpy() for layer, v in feats.items()},
            np.asarray(labels_all))


def load_feature_npz(path: str):
    """Load a {layer: features, 'labels': ...} npz produced elsewhere."""
    data = np.load(path, allow_pickle=True)
    feats = {k: data[k] for k in data.files if k != "labels"}
    labels = data["labels"] if "labels" in data.files else None
    return feats, labels


def ensure_output_dir(path: str | None = None) -> str:
    out = path or OUTPUT_DIR
    os.makedirs(out, exist_ok=True)
    return out


def load_labels(samples, pca_labels_path: str | None = None,
                semantic_labels_path: str | None = None):
    """(pca_labels, sem_labels, synsets, img_paths) of (path, label, image
    name) samples: the 32-class PCA-label CSV and the semantic-category
    CSV joined on the image name (−1 where missing); the synset is the
    name's prefix."""
    def read_map(path):
        if not path or not os.path.exists(path):
            return {}
        with open(path) as f:
            return {r["image"]: int(r["pca_label"]) for r in csv.DictReader(f)}

    pca_map = read_map(pca_labels_path)
    sem_map = read_map(semantic_labels_path)
    pca_labels, sem_labels, synsets, img_paths = [], [], [], []
    for img_path, _, img_id in samples:
        pca_labels.append(pca_map.get(img_id, -1))
        sem_labels.append(sem_map.get(img_id, -1))
        synsets.append(img_id.split("_")[0])
        img_paths.append(os.path.abspath(img_path))
    return (np.asarray(pca_labels), np.asarray(sem_labels),
            np.asarray(synsets), np.asarray(img_paths))


def embedding_backend() -> str | None:
    """The name ``embed_2d`` would return ("UMAP" or "t-SNE"), or None
    where neither umap nor sklearn imports."""
    try:
        import umap  # noqa: F401

        return "UMAP"
    except ImportError:
        pass
    try:
        from sklearn.manifold import TSNE  # noqa: F401

        return "t-SNE"
    except ImportError:
        return None


def embed_2d(feats: np.ndarray, seed: int = SEED, metric: str = "cosine"):
    """(coords (n, 2), method name): umap where it imports, else sklearn
    t-SNE (perplexity min(30, max(2, n // 4)), PCA init); ImportError
    where neither does."""
    try:
        import umap

        reducer = umap.UMAP(n_neighbors=30, min_dist=0.1, metric=metric,
                            random_state=seed, verbose=False)
        return reducer.fit_transform(feats.astype(np.float32)), "UMAP"
    except ImportError:
        from sklearn.manifold import TSNE

        perplexity = min(30, max(2, feats.shape[0] // 4))
        reducer = TSNE(n_components=2, metric=metric, random_state=seed,
                       perplexity=perplexity, init="pca")
        return reducer.fit_transform(feats.astype(np.float32)), "t-SNE"


def load_models_pair(cfg_id: int = 32, seed: int = 1, checkpoint_dir: str | None = None,
                     device=None):
    """(torchvision AlexNet with IMAGENET1K weights, the cfg_id checkpoint's
    ``checkpoint_epoch_20.pth``) on ``device``. Without a local weights file
    the AlexNet keeps its random init, with a warning, as in the JAX
    package."""
    from visreps_tpu_torch.core.config import Config
    from visreps_tpu_torch.models.zoo import load_model

    pretrained = load_model(Config({
        "load_model_from": "torchvision", "model_name": "AlexNet",
        "pretrained_dataset": "imagenet1k",
    }), device=device)
    trained = load_model(Config({
        "load_model_from": "checkpoint", "seed": seed, "cfg_id": cfg_id,
        "checkpoint_dir": checkpoint_dir or os.environ.get("CHECKPOINT_DIR", "checkpoints"),
        "checkpoint_model": "checkpoint_epoch_20.pth",
    }), device=device)
    rprint(f"Loaded pretrained + cfg{cfg_id}{'abc'[seed - 1]} models", style="success")
    return pretrained, trained
