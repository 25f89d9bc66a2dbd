"""ImageNet classes grouped into 8 semantic super-categories (port of
``experiments/wordnet/make_semantic_labels.py``).

Each class's Level-6 synset (on its SHORTEST hypernym path) maps through
the hand-curated ``SUPER_CATEGORIES`` table (protocol data: the same
grouping gives the same labels) to one of 8 groups; an unmapped synset
raises, listing them all. Writes ``semantic_categories.csv``
(image,pca_label, one row per image in sample order) and a
``*_mapping.txt`` description beside it.

Usage:
  IMAGENET_DATA_DIR=... WORDNET_PATHS_JSON=paths.json \\
  python -m visreps_tpu_torch.experiments.wordnet.make_semantic_labels [--out sem.csv]
"""
from __future__ import annotations

import argparse
import csv
import os
from collections import Counter
from pathlib import Path

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.experiments.wordnet.hierarchy import WordnetHierarchy

SUPER_CATEGORIES = {
    "Animals": ["animal.n.01"],
    "Natural World": [
        "plant.n.02", "plant_organ.n.01", "fungus.n.01",
        "alp.n.01", "cliff.n.01", "reef.n.01", "dune.n.01",
        "geyser.n.01", "lakeside.n.01", "lunar_crater.n.01",
        "promontory.n.01", "bar.n.08", "seashore.n.01",
        "valley.n.01", "volcano.n.02",
    ],
    "Food & Produce": ["vegetable.n.01", "edible_fruit.n.01", "starches.n.01"],
    "Structures & Architecture": [
        "building.n.01", "establishment.n.04", "obstruction.n.01",
        "protective_covering.n.01", "top.n.09", "memorial.n.03",
        "tower.n.01", "supporting_structure.n.01", "housing.n.01",
        "column.n.06", "bridge.n.01", "defensive_structure.n.01",
        "coil.n.01", "colonnade.n.01", "landing.n.02", "fountain.n.01",
        "house_of_cards.n.02", "building_complex.n.01", "stadium.n.01",
        "shelter.n.01", "pool.n.01", "workplace.n.01", "arch.n.04",
    ],
    "Domestic & Apparel": [
        "clothing.n.01", "footwear.n.02", "cloth_covering.n.01", "towel.n.01",
        "bib.n.01", "dishrag.n.01", "handkerchief.n.01", "mask.n.01",
        "furnishing.n.02", "floor_cover.n.01", "toiletry.n.01", "powder.n.03",
    ],
    "Vehicles & Transport": ["conveyance.n.03"],
    "Tools & Electronics": [
        "device.n.01", "equipment.n.01", "implement.n.01",
        "system.n.01", "memory.n.04", "medium.n.01",
    ],
    "General Objects": [
        "container.n.01", "consumer_goods.n.01", "product.n.02",
        "brick.n.01", "coating.n.01", "screen.n.04",
    ],
}
SYNSET_TO_SUPER = {s: cat for cat, syns in SUPER_CATEGORIES.items() for s in syns}
CATEGORY_ORDER = list(SUPER_CATEGORIES.keys())


def classify_classes(hierarchy: WordnetHierarchy, wnid_of_class,
                     n_classes: int = 1000, level: int = 6):
    """(class index → super-category, Counter of classes per category);
    raises where a class has no synset or its Level-``level`` synset is
    in no category."""
    class_to_category = {}
    counts = Counter()
    unmapped = set()
    for class_idx in range(n_classes):
        wnid = wnid_of_class(class_idx)
        lvl = hierarchy.level_synset(wnid, level)
        if lvl is None:
            raise ValueError(f"Class {class_idx} ({wnid}) has no Level {level} synset")
        if lvl not in SYNSET_TO_SUPER:
            unmapped.add(lvl)
        else:
            cat = SYNSET_TO_SUPER[lvl]
            class_to_category[class_idx] = cat
            counts[cat] += 1
    if unmapped:
        raise ValueError(
            f"{len(unmapped)} unmapped Level {level} synsets; add to "
            f"SUPER_CATEGORIES: {sorted(unmapped)}")
    return class_to_category, counts


def make_labels(ds, hierarchy: WordnetHierarchy, out_file: str,
                n_classes: int = 1000, level: int = 6) -> str:
    category_to_label = {c: i for i, c in enumerate(CATEGORY_ORDER)}
    class_to_category, counts = classify_classes(
        hierarchy, ds.get_wnid_from_label, n_classes, level)

    for cat in CATEGORY_ORDER:
        rprint(f"  {category_to_label[cat]}: {cat:<26} {counts[cat]:4} classes", style="info")

    os.makedirs(os.path.dirname(out_file) or ".", exist_ok=True)
    with open(out_file, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["image", "pca_label"])
        for _, class_idx, img_id in ds.samples:
            w.writerow([img_id, category_to_label[class_to_category[class_idx]]])

    mapping_file = out_file.replace(".csv", "_mapping.txt")
    with open(mapping_file, "w") as f:
        f.write(f"{len(CATEGORY_ORDER)} Super-Categories for ImageNet\n")
        f.write("=" * 60 + "\n\n")
        for cat in CATEGORY_ORDER:
            f.write(f"{category_to_label[cat]}: {cat} ({counts[cat]} classes)\n")
            f.write(f"   Level 6 synsets: {', '.join(SUPER_CATEGORIES[cat])}\n\n")
    rprint(f"Saved {out_file} and {mapping_file}", style="success")
    return out_file


def main(argv=None):
    from visreps_tpu_torch.core.env import get_env_var
    from visreps_tpu_torch.data.obj_cls import ImageNetDataset

    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=str(Path(__file__).parent / "semantic_categories.csv"))
    args = parser.parse_args(argv)

    ds = ImageNetDataset(get_env_var("IMAGENET_DATA_DIR"), split="all")
    hierarchy = WordnetHierarchy.load(sorted(set(ds.folder_labels)))
    return make_labels(ds, hierarchy, args.out)


if __name__ == "__main__":
    main()
