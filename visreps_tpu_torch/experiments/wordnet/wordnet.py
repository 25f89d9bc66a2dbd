"""WordNet hierarchy exploration CLI (port of
``experiments/wordnet/wordnet.py``): the hyponym tree under a synset and
the hypernym ancestry of an ImageNet class, from the hierarchy of
``hierarchy.py`` (a JSON snapshot or nltk).

Usage:
  python -m visreps_tpu_torch.experiments.wordnet.wordnet \\
      [--tree entity.n.01] [--ancestry n02084071] [--max_depth 3]
"""
from __future__ import annotations

import argparse

from visreps_tpu_torch.experiments.wordnet.hierarchy import WordnetHierarchy


def print_hierarchy(hierarchy: WordnetHierarchy, name: str, depth: int = 0,
                    max_depth: int = 3, max_children: int = 5, out=print):
    """Print the (induced) hyponym tree under ``name``, depth first."""
    out(f"{'  ' * depth}- {name}")
    if depth >= max_depth:
        return
    kids = hierarchy.children(name)
    for i, child in enumerate(kids):
        if i >= max_children:
            out(f"{'  ' * depth}  ... ({len(kids) - max_children} more)")
            break
        print_hierarchy(hierarchy, child, depth + 1, max_depth, max_children, out)


def print_ancestry(hierarchy: WordnetHierarchy, wnid: str, out=print):
    """Every hypernym path from the root to the wnid's synset."""
    paths = hierarchy.hypernym_paths(wnid)
    if not paths:
        out(f"(no paths for {wnid})")
        return
    for j, path in enumerate(paths):
        out(f"Path {j + 1} ({len(path)} levels):")
        for lvl, name in enumerate(path):
            out(f"  {lvl}: {name}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", help="synset name to print hyponyms of")
    parser.add_argument("--ancestry", help="wnid to print hypernym paths of")
    parser.add_argument("--max_depth", type=int, default=3)
    args = parser.parse_args(argv)

    from visreps_tpu_torch.core.env import get_env_var
    from visreps_tpu_torch.data.obj_cls import ImageNetDataset

    ds = ImageNetDataset(get_env_var("IMAGENET_DATA_DIR"), split="all")
    hierarchy = WordnetHierarchy.load(sorted(set(ds.folder_labels)))
    if args.tree:
        print_hierarchy(hierarchy, args.tree, max_depth=args.max_depth)
    if args.ancestry:
        print_ancestry(hierarchy, args.ancestry)


if __name__ == "__main__":
    main()
