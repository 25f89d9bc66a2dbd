"""Build folder_labels.json, wnid folder → class index in sorted-wnid
order (port of ``scripts/create_imagenet_labels.py``).

Usage:
  python -m visreps_tpu_torch.scripts.create_imagenet_labels \\
      --imagenet-dir DIR_OF_nXXXXXXXX_FOLDERS [--out folder_labels.json]
"""
from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--imagenet-dir", required=True, help="dir of nXXXXXXXX folders")
    parser.add_argument("--out", default="folder_labels.json")
    args = parser.parse_args(argv)

    wnids = sorted(
        d for d in os.listdir(args.imagenet_dir)
        if d.startswith("n") and os.path.isdir(os.path.join(args.imagenet_dir, d))
    )
    labels = {wnid: i for i, wnid in enumerate(wnids)}
    with open(args.out, "w") as f:
        json.dump(labels, f, indent=1)
    print(f"Saved {args.out}: {len(labels)} classes")


if __name__ == "__main__":
    main()
