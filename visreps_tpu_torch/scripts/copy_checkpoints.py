"""Sync checkpoint directories between machines with rsync (port of
``scripts/copy_checkpoints.py``). Prints the rsync command and exits
with its code.

Usage:
  python -m visreps_tpu_torch.scripts.copy_checkpoints --src host:/path/model_checkpoints/base \\
      [--dst model_checkpoints/] [--include PATTERN ...] [--dry-run]
"""
from __future__ import annotations

import argparse
import subprocess


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", required=True, help="e.g. host:/path/model_checkpoints/base")
    parser.add_argument("--dst", default="model_checkpoints/")
    parser.add_argument("--include", nargs="*", default=["checkpoint_epoch_20.pth", "config.json"])
    parser.add_argument("--dry-run", action="store_true")
    args = parser.parse_args(argv)

    cmd = ["rsync", "-av", "--progress"]
    if args.include:
        cmd += ["--include=*/"]
        cmd += [f"--include={pat}" for pat in args.include]
        cmd += ["--exclude=*"]
    if args.dry_run:
        cmd.append("--dry-run")
    cmd += [args.src, args.dst]
    print(" ".join(cmd))
    raise SystemExit(subprocess.run(cmd).returncode)


if __name__ == "__main__":
    main()
