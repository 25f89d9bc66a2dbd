"""Create imagenet-mini-N beside the ImageNet folder: the first N images
(sorted file names, .jpeg/.jpg) of every class folder, as symlinks or,
with ``--copy``, copies; targets that exist are kept (port of
``scripts/create_imagenet_mini.py``).

Usage:
  python -m visreps_tpu_torch.scripts.create_imagenet_mini \\
      --imagenet-dir .../train [--images-per-class 50] [--copy]
"""
from __future__ import annotations

import argparse
import os
import shutil
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--imagenet-dir", required=True)
    parser.add_argument("--images-per-class", type=int, default=50)
    parser.add_argument("--copy", action="store_true", help="copy instead of symlink")
    args = parser.parse_args(argv)

    src = Path(args.imagenet_dir)
    dst = src.parent / f"imagenet-mini-{args.images_per_class}"
    dst.mkdir(exist_ok=True)

    n_total = 0
    for folder in sorted(os.listdir(src)):
        if not folder.startswith("n") or not (src / folder).is_dir():
            continue
        out_dir = dst / folder
        out_dir.mkdir(exist_ok=True)
        files = sorted(
            f for f in os.listdir(src / folder) if f.lower().endswith((".jpeg", ".jpg"))
        )[: args.images_per_class]
        for f in files:
            target = out_dir / f
            if target.exists():
                continue
            if args.copy:
                shutil.copy2(src / folder / f, target)
            else:
                target.symlink_to((src / folder / f).resolve())
        n_total += len(files)
    print(f"Created {dst}: {n_total} images")


if __name__ == "__main__":
    main()
