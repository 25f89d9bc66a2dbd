"""Object-classification datasets and loaders (port of
``visreps_tpu/data/obj_cls.py:26-250``).

  * ImageNet as flat ``n*/`` folders with a ``folder_labels.json``
    wnid → label map, samples sorted by file name, a seeded (42)
    ``torch.randperm`` 80/20 train/test split and a ``train_fraction``
    subsample; ``imagenet-mini-N`` sibling directories;
  * Tiny-ImageNet in ImageFolder layout (``train/``, ``val/``);
  * PCA labels: ``PCADataset`` replaces each sample's label with the one
    in ``{pca_labels_folder}/n_classes_{N}.csv`` (columns ``image``,
    ``pca_label``) and drops unlabelled samples. The CSV is read with the
    ``csv`` module (the JAX package uses pandas), with the same checks.
"""
from __future__ import annotations

import csv
import json
import os
from pathlib import Path

import torch

from visreps_tpu_torch.core.env import get_env_var
from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.data.loader import LabeledDataset, PrefetchLoader
from visreps_tpu_torch.data.transforms import get_transform


def _randperm(n: int, seed: int = 42) -> list[int]:
    return torch.randperm(n, generator=torch.Generator().manual_seed(seed)).tolist()


class ImageNetDataset(LabeledDataset):
    """Flat-folder ImageNet with a JSON label map and a seeded split."""

    def __init__(self, base_path, split="train", transform=None, train_ratio=0.8,
                 train_fraction=1.0, label_file=None):
        if split not in ("train", "test", "all"):
            raise ValueError(f"Invalid split: {split}")
        label_file = label_file or os.path.join(get_env_var("IMAGENET_LOCAL_DIR"),
                                                "folder_labels.json")
        self.num_classes = 1000
        with open(label_file) as f:
            self.folder_labels = json.load(f)
        if not os.path.isdir(base_path):
            raise FileNotFoundError(f"ImageNet base path not found: {base_path}")
        samples = []
        for folder in os.listdir(base_path):
            folder_path = os.path.join(base_path, folder)
            if (not folder.startswith("n") or not os.path.isdir(folder_path)
                    or folder not in self.folder_labels):
                continue
            label = int(self.folder_labels[folder])
            for fname in os.listdir(folder_path):
                if fname.lower().endswith((".jpeg", ".jpg")):
                    samples.append((os.path.join(folder_path, fname), label, fname))
        samples.sort(key=lambda s: s[2])

        if split in ("train", "test") and samples:
            indices = _randperm(len(samples), 42)
            cut = int(len(samples) * train_ratio)
            samples = [samples[i] for i in (indices[:cut] if split == "train" else indices[cut:])]
        if split == "train" and train_fraction < 1.0 and samples:
            n_keep = max(1, int(len(samples) * train_fraction))
            samples = [samples[i] for i in sorted(_randperm(len(samples), 42)[:n_keep])]
        super().__init__(samples, transform)

    def get_wnid_from_label(self, label_idx: int) -> str:
        """The wnid whose ``folder_labels.json`` entry is ``label_idx``."""
        for wnid, idx in self.folder_labels.items():
            if int(idx) == label_idx:
                return wnid
        raise ValueError(f"Label index {label_idx} not found.")

    def get_wordnet_synset(self, label_idx: int):
        """The nltk Synset of a class index; None (with a warning) where
        nltk is not installed or has no synset for the wnid."""
        try:
            import nltk
            from nltk.corpus import wordnet as wn
        except ImportError:
            rprint("nltk not installed; get_wordnet_synset unavailable", style="warning")
            return None
        try:
            wn.ensure_loaded()
        except LookupError:
            nltk.download("wordnet")
            nltk.download("omw-1.4")
        wnid = self.get_wnid_from_label(label_idx)
        try:
            return wn.synset_from_pos_and_offset("n", int(wnid[1:]))
        except Exception as e:
            rprint(f"Error retrieving synset for {wnid}: {e}", style="warning")
            return None


class TinyImageNetDataset(LabeledDataset):
    """ImageFolder-style Tiny-ImageNet (one subdirectory per class)."""

    def __init__(self, base_path: str, split: str, transform=None):
        root = os.path.join(base_path, "train" if split == "train" else "val")
        self.classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        self.num_classes = len(self.classes)
        samples = []
        for label, cls in enumerate(self.classes):
            for dirpath, _, files in sorted(os.walk(os.path.join(root, cls))):
                for fname in sorted(files):
                    if fname.lower().endswith((".jpeg", ".jpg", ".png")):
                        p = os.path.join(dirpath, fname)
                        samples.append((p, label, os.path.relpath(p, root)))
        super().__init__(samples, transform)


def _read_pca_labels(path: str) -> dict[str, int]:
    """{image basename: label} from a CSV with ``image`` and ``pca_label``
    columns; labels must be non-negative integers."""
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        for col in ("image", "pca_label"):
            if col not in (reader.fieldnames or []):
                raise ValueError(f"PCA CSV must include '{col}'")
        rows = list(reader)
    labels = {}
    for row in rows:
        try:
            label = int(row["pca_label"])
        except (TypeError, ValueError):
            raise ValueError("PCA labels must be non-negative integers") from None
        if label < 0:
            raise ValueError("PCA labels must be non-negative integers")
        labels[os.path.basename(row["image"])] = label
    if not rows:
        raise ValueError("PCA labels must be non-negative integers")
    return labels


class PCADataset(LabeledDataset):
    """Labels replaced from a PCA-label CSV; unlabelled samples dropped."""

    def __init__(self, base_dataset: LabeledDataset, pca_labels_path: str, num_classes: int):
        label_map = _read_pca_labels(pca_labels_path)
        total = len(base_dataset.samples)
        samples = [(p, label_map[os.path.basename(img_id)], img_id)
                   for (p, _, img_id) in base_dataset.samples
                   if os.path.basename(img_id) in label_map]
        rprint(f"Filtered dataset from {total} to {len(samples)} samples with PCA labels "
               f"({100.0 * len(samples) / max(total, 1):.1f}%)")
        self.num_classes = num_classes
        super().__init__(samples, base_dataset.transform)


def wrap_with_pca(dataset, base_path, cfg, split):
    n_classes = cfg.get("pca_n_classes")
    if n_classes is None:
        raise ValueError("pca_n_classes must be specified in config when pca_labels=True")
    pca_path = os.path.join(base_path, f"n_classes_{n_classes}.csv")
    rprint(f"Applying PCA labels for {split} from {pca_path}")
    return PCADataset(dataset, pca_path, num_classes=n_classes)


def _make_loader(dataset, cfg, shuffle=True):
    return PrefetchLoader(dataset, batch_size=cfg.get("batchsize", 128), shuffle=shuffle,
                          num_workers=cfg.get("num_workers", 16), seed=cfg.get("seed", 0))


def prepare_imgnet_data(cfg, base_path=None, shuffle=True, train_test_split=True):
    if base_path is None:
        base_path = cfg.get("dataset_path", get_env_var("IMAGENET_DATA_DIR"))
    datasets, loaders = {}, {}
    for split in (("train", "test") if train_test_split else ("all",)):
        augment = cfg.get("data_augment", False) and split == "train" and shuffle
        ds = ImageNetDataset(base_path, split=split,
                             transform=get_transform("imgnet", data_augment=augment),
                             train_fraction=cfg.get("train_fraction", 1.0),
                             label_file=cfg.get("label_file"))
        if cfg.get("pca_labels", False):
            # os.path.join keeps an absolute pca_labels_folder as it is
            ds = wrap_with_pca(ds, os.path.join("pca_labels", cfg.get("pca_labels_folder")),
                               cfg, split)
        datasets[split] = ds
        loaders[split] = _make_loader(ds, cfg, shuffle)
    rprint(f"ImageNet: {', '.join(f'{k}={len(v)}' for k, v in datasets.items())}")
    return datasets, loaders


def prepare_tinyimgnet_data(cfg, shuffle=True, train_test_split=True):
    base_path = cfg.get("dataset_path", get_env_var("TINY_IMAGENET_DATA_DIR"))
    datasets, loaders = {}, {}
    for split in (("train", "val") if train_test_split else ("val",)):
        augment = cfg.get("data_augment", True) and split == "train" and shuffle
        ds = TinyImageNetDataset(base_path, split,
                                 get_transform("tiny-imagenet", data_augment=augment))
        frac = cfg.get("train_fraction", 1.0)
        if split == "train" and frac < 1.0 and ds.samples:
            n_keep = max(1, int(len(ds.samples) * frac))
            ds.samples = [ds.samples[i] for i in sorted(_randperm(len(ds.samples), 42)[:n_keep])]
        if cfg.get("pca_labels", False):
            ds = wrap_with_pca(ds, os.path.join("pca_labels", cfg.get("pca_labels_folder")),
                               cfg, split)
        key = split if train_test_split else "all"
        datasets[key] = ds
        loaders[key] = _make_loader(ds, cfg, shuffle)
    rprint(f"Tiny ImageNet: {', '.join(f'{k}={len(v)}' for k, v in datasets.items())}")
    return datasets, loaders


def get_obj_cls_loader(cfg, shuffle=True, train_test_split=True):
    """(datasets, loaders): by default shuffled and split train/test
    (train/val for Tiny-ImageNet), as training takes them; with
    ``train_test_split=False`` one unsplit ``"all"`` split (Tiny-ImageNet:
    its val split), as feature extraction takes it."""
    name = cfg.get("dataset", "tiny-imagenet")
    if name == "tiny-imagenet":
        return prepare_tinyimgnet_data(cfg, shuffle, train_test_split)
    if name == "imagenet":
        return prepare_imgnet_data(cfg, shuffle=shuffle, train_test_split=train_test_split)
    if name.startswith("imagenet-mini-"):
        try:
            n = int(name.split("-")[-1])
        except ValueError:
            raise ValueError(f"Invalid imagenet-mini format: {name}") from None
        mini = Path(cfg.get("dataset_path") or get_env_var("IMAGENET_DATA_DIR")).parent / \
            f"imagenet-mini-{n}"
        if not mini.exists():
            raise ValueError(f"ImageNet mini dataset not found at {mini}")
        return prepare_imgnet_data(cfg, base_path=str(mini), shuffle=shuffle,
                                   train_test_split=train_test_split)
    raise ValueError(f"Unsupported dataset: {name}")
