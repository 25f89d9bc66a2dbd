"""WordNet-hierarchy coarse labels for ImageNet, depths 1–7 (port of
``experiments/wordnet/make_wordnet_labels.py``).

For each depth, every ImageNet class maps to its ancestor synset at that
depth along the LONGEST hypernym path; the sorted unique ancestors are
the label ids, and ``{out_dir}/n_classes_{K}.csv`` (columns
image,pca_label) holds one row per image in the dataset's sample order —
the "wordnet" label source of ``--mode train``
(``pca_labels_folder=wordnet``). The hierarchy is a
``$WORDNET_PATHS_JSON`` snapshot or nltk (``hierarchy.py``).

Usage:
  IMAGENET_DATA_DIR=... WORDNET_PATHS_JSON=paths.json \\
  python -m visreps_tpu_torch.experiments.wordnet.make_wordnet_labels \\
      [--out_dir pca_labels/wordnet]
"""
from __future__ import annotations

import argparse
import csv
import os

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.experiments.wordnet.hierarchy import WordnetHierarchy

MIN_DEPTH, MAX_DEPTH = 1, 7
LABELS_FOLDER = "wordnet"


def class_to_ancestor_at_depth(hierarchy: WordnetHierarchy, wnid_of_class,
                               depth: int, n_classes: int = 1000) -> dict:
    """Class index → its ancestor synset at ``depth`` (longest path)."""
    out = {}
    for class_idx in range(n_classes):
        anc = hierarchy.ancestor_at_depth(wnid_of_class(class_idx), depth)
        if anc is not None:
            out[class_idx] = anc
    return out


def make_labels(ds, hierarchy: WordnetHierarchy, labels_dir: str,
                min_depth: int = MIN_DEPTH, max_depth: int = MAX_DEPTH,
                n_classes: int = 1000) -> dict:
    """One CSV per depth; returns {depth: (n_classes, path)}."""
    os.makedirs(labels_dir, exist_ok=True)
    written = {}
    rprint("Depth | # Classes | Output File", style="info")
    for depth in range(min_depth, max_depth + 1):
        c2a = class_to_ancestor_at_depth(hierarchy, ds.get_wnid_from_label, depth, n_classes)
        unique = sorted(set(c2a.values()))
        label_of = {a: i for i, a in enumerate(unique)}
        k = len(unique)
        out_path = os.path.join(labels_dir, f"n_classes_{k}.csv")
        with open(out_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["image", "pca_label"])
            for _, class_idx, img_id in ds.samples:
                anc = c2a.get(class_idx)
                if anc is not None:
                    w.writerow([img_id, label_of[anc]])
        written[depth] = (k, out_path)
        rprint(f"{depth:5d} | {k:9d} | {out_path}", style="info")
    return written


def main(argv=None):
    from visreps_tpu_torch.core.env import get_env_var
    from visreps_tpu_torch.data.obj_cls import ImageNetDataset

    parser = argparse.ArgumentParser()
    parser.add_argument("--out_dir", default=os.path.join("pca_labels", LABELS_FOLDER))
    args = parser.parse_args(argv)

    ds = ImageNetDataset(get_env_var("IMAGENET_DATA_DIR"), split="all")
    rprint(f"Loaded {len(ds.samples)} images", style="success")
    hierarchy = WordnetHierarchy.load(sorted(set(ds.folder_labels)))
    written = make_labels(ds, hierarchy, args.out_dir)
    rprint("Done.", style="success")
    return written


if __name__ == "__main__":
    main()
