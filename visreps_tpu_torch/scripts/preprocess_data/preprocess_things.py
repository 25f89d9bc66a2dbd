"""Build things_split.pkl: concept embeddings and per-concept image ids
(port of ``scripts/preprocess_data/preprocess_things.py``).

Reads the THINGS SPoSE embedding table (one row per concept) and the
THINGS object_images tree into {"embeddings": {concept: (66,) float32},
"image_ids": {concept: [stimulus id]}, "image_paths": {stimulus id:
path}}. The JAX script reads the table with pandas, which the card's
machine lacks; here ``csv`` reads it by pandas' rules for such a table:
the first line is the header, blank lines are skipped, the first column
is the concept and the rest of a row its embedding (float32). A concept
without a folder, or whose folder holds no .jpg/.jpeg/.png, is skipped
and counted.

Usage:
  python -m visreps_tpu_torch.scripts.preprocess_data.preprocess_things \\
      --embeddings spose_embedding_66d.tsv --images-root .../object_images \\
      [--out datasets/neural/things/things_split.pkl]
"""
from __future__ import annotations

import argparse
import csv
import os
import pickle

import numpy as np


def read_table(path: str) -> list[list[str]]:
    """The table's data rows (header dropped, blank lines skipped): tab-
    separated for a ``.tsv`` file, else comma-separated."""
    sep = "\t" if path.endswith(".tsv") else ","
    with open(path, newline="") as f:
        rows = [row for row in csv.reader(f, delimiter=sep) if row]
    return rows[1:]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--embeddings", required=True,
                        help="TSV/CSV: first column concept, remaining 66 dims")
    parser.add_argument("--images-root", required=True,
                        help=".../hebart2019.things/images/object_images")
    parser.add_argument("--out", default="datasets/neural/things/things_split.pkl")
    args = parser.parse_args(argv)

    embeddings = {}
    image_ids = {}
    image_paths = {}
    missing = 0
    for row in read_table(args.embeddings):
        concept = row[0]
        emb = np.asarray([float(v) for v in row[1:]], np.float64).astype(np.float32)
        concept_dir = os.path.join(args.images_root, concept)
        if not os.path.isdir(concept_dir):
            missing += 1
            continue
        ids = []
        for fname in sorted(os.listdir(concept_dir)):
            if fname.lower().endswith((".jpg", ".jpeg", ".png")):
                sid = os.path.splitext(fname)[0]
                ids.append(sid)
                image_paths[sid] = os.path.join(concept_dir, fname)
        if not ids:
            missing += 1
            continue
        embeddings[concept] = emb
        image_ids[concept] = ids

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "wb") as f:
        pickle.dump(
            {"embeddings": embeddings, "image_ids": image_ids, "image_paths": image_paths}, f
        )
    n_imgs = sum(len(v) for v in image_ids.values())
    print(f"Saved {args.out}: {len(embeddings)} concepts, {n_imgs} images "
          f"({missing} concepts skipped, no images)")


if __name__ == "__main__":
    main()
