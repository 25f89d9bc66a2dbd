"""WordNet hypernym hierarchy of the label makers (port of
``experiments/wordnet/hierarchy.py``).

Two sources behind one small provider:

  * a JSON snapshot mapping wnid → list of hypernym paths (each a
    root-first list of synset names), named by ``$WORDNET_PATHS_JSON``;
    ``python -m visreps_tpu_torch.experiments.wordnet.hierarchy export
    OUT.json`` writes one where nltk and its wordnet corpus exist;
  * nltk, imported only when asked for, where the corpus is on disk.

``load`` tries the snapshot first, then nltk, then raises. Every
consumer works the same against either source.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional


class WordnetHierarchy:
    """Hypernym paths per ImageNet wnid (e.g. 'n02084071')."""

    def __init__(self, paths: Dict[str, List[List[str]]]):
        self.paths = paths

    @classmethod
    def from_nltk(cls, wnids) -> "WordnetHierarchy":
        from nltk.corpus import wordnet as wn

        paths = {}
        for wnid in wnids:
            syn = wn.synset_from_pos_and_offset("n", int(wnid[1:]))
            paths[wnid] = [[s.name() for s in p] for p in syn.hypernym_paths()]
        return cls(paths)

    @classmethod
    def from_json(cls, path: str) -> "WordnetHierarchy":
        with open(path) as f:
            return cls(json.load(f))

    @classmethod
    def load(cls, wnids=None) -> "WordnetHierarchy":
        """The ``$WORDNET_PATHS_JSON`` snapshot if set, else nltk (needs the
        wordnet corpus on disk and the wnid list)."""
        snap = os.environ.get("WORDNET_PATHS_JSON")
        if snap:
            return cls.from_json(snap)
        if wnids is not None:
            try:
                from nltk.corpus import wordnet as wn

                wn.ensure_loaded()
                return cls.from_nltk(wnids)
            except Exception:
                pass
        raise RuntimeError(
            "No WordNet source: set WORDNET_PATHS_JSON to a hypernym-path "
            "snapshot, or install nltk + its wordnet corpus")

    def hypernym_paths(self, wnid: str) -> List[List[str]]:
        return self.paths.get(wnid, [])

    def ancestor_at_depth(self, wnid: str, depth: int) -> Optional[str]:
        """The ancestor at ``depth`` along the LONGEST path (the most
        specific route to the root); the leaf where the path is shorter."""
        paths = self.hypernym_paths(wnid)
        if not paths:
            return None
        path = max(paths, key=len)
        return path[min(depth, len(path) - 1)]

    def level_synset(self, wnid: str, level: int = 6) -> Optional[str]:
        """The synset at ``level`` along the SHORTEST path; the leaf where
        the path is not deeper than ``level``."""
        paths = self.hypernym_paths(wnid)
        if not paths:
            return None
        path = min(paths, key=len)
        if len(path) > level:
            return path[level]
        return path[-1] if path else None

    def children(self, name: str) -> List[str]:
        """The immediate hyponyms the stored paths show (a snapshot holds
        ancestor chains only, so this is the induced sub-hierarchy)."""
        kids = set()
        for paths in self.paths.values():
            for p in paths:
                for a, b in zip(p, p[1:]):
                    if a == name:
                        kids.add(b)
        return sorted(kids)


def export_snapshot(wnids, out_path: str) -> None:
    """Write a snapshot for ``WORDNET_PATHS_JSON`` (needs nltk and its
    wordnet corpus)."""
    h = WordnetHierarchy.from_nltk(wnids)
    with open(out_path, "w") as f:
        json.dump(h.paths, f)


def main(argv=None):
    import argparse

    from visreps_tpu_torch.core.env import get_env_var
    from visreps_tpu_torch.data.obj_cls import ImageNetDataset

    parser = argparse.ArgumentParser()
    parser.add_argument("cmd", choices=["export"])
    parser.add_argument("out")
    args = parser.parse_args(argv)
    ds = ImageNetDataset(get_env_var("IMAGENET_DATA_DIR"), split="all")
    wnids = sorted(set(ds.folder_labels))
    export_snapshot(wnids, args.out)
    print(f"Wrote {len(wnids)} wnid hierarchies to {args.out}")


if __name__ == "__main__":
    main()
