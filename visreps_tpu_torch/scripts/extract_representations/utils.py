"""Shared feature-extraction utilities for the source-model pipelines
(port of ``scripts/extract_representations/utils.py``): stream the whole
ImageNet (``train_test_split=False``, the ``"all"`` split, in the JAX
script's order) through a feature function and save (features,
image_ids) to .npz.
"""
from __future__ import annotations

import numpy as np
import torch

from visreps_tpu_torch.analysis.extract_representations import _WithIds
from visreps_tpu_torch.core.config import Config
from visreps_tpu_torch.core.logging import rprint


def iterate_imagenet(cfg_overrides: dict | None = None, batch_size: int = 256):
    """(loader of (images (b, h, w, 3) float32, image ids), image count)
    over ALL ImageNet images (``IMAGENET_DATA_DIR`` and
    ``IMAGENET_LOCAL_DIR/folder_labels.json`` unless the overrides name
    ``dataset_path`` / ``label_file``)."""
    from visreps_tpu_torch.data.loader import PrefetchLoader
    from visreps_tpu_torch.data.obj_cls import get_obj_cls_loader

    cfg = Config({
        "dataset": "imagenet",
        "batchsize": batch_size,
        "num_workers": 16,
        "pca_labels": False,
        "data_augment": False,
        **(cfg_overrides or {}),
    })
    datasets, _ = get_obj_cls_loader(cfg, shuffle=False, train_test_split=False)
    ds = datasets["all"]
    loader = PrefetchLoader(_WithIds(ds), batch_size=batch_size, shuffle=False, num_workers=16)
    return loader, len(ds)


def extract_and_save(extract_fn, out_path: str, cfg_overrides=None, batch_size: int = 256):
    """Run ``extract_fn(batch) -> (b, D)`` features (a tensor on any
    device, or an array) over all images; save ``features`` (N, D)
    float32 and ``image_ids`` to ``out_path``."""
    loader, total = iterate_imagenet(cfg_overrides, batch_size)
    feats, ids = [], []
    done = 0
    for batch, batch_ids in loader:
        feats.append(torch.as_tensor(extract_fn(batch)).to("cpu", torch.float32))
        ids.extend(batch_ids)
        done += len(batch_ids)
        if done % (batch_size * 20) == 0:
            rprint(f"  {done}/{total} images", style="info")
    features = torch.cat(feats).numpy()
    np.savez(out_path, features=features, image_ids=np.asarray(ids))
    rprint(f"Saved {out_path}: {features.shape}", style="success")
    return out_path
