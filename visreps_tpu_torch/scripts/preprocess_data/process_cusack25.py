"""Build the Cusack2025 infant-fMRI pickle, region × age group (port of
``scripts/preprocess_data/process_cusack25.py``).

Input: per-(region, age group) files ``{region}_{age}.npz`` (split at
the LAST underscore) with ``stimulus`` ids and ``values`` (n_stim,
voxels). Output: data[region][age] = {stimulus id: float32 response};
the display images live in ``datasets/neural/cusack2025/display_images/``.

Usage:
  python -m visreps_tpu_torch.scripts.preprocess_data.process_cusack25 \\
      --npz-dir cusack/ [--out datasets/neural/cusack2025/fmri_responses.pkl]
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--npz-dir", required=True)
    parser.add_argument("--out", default="datasets/neural/cusack2025/fmri_responses.pkl")
    args = parser.parse_args(argv)

    data: dict = {}
    for fname in sorted(os.listdir(args.npz_dir)):
        if not fname.endswith(".npz"):
            continue
        region, age = fname[:-4].rsplit("_", 1)
        z = np.load(os.path.join(args.npz_dir, fname), allow_pickle=True)
        data.setdefault(region, {})[age] = {
            str(s): v.astype(np.float32)
            for s, v in zip(z["stimulus"], z["values"])
        }
        print(f"  {region}/{age}: {len(z['stimulus'])} stimuli")

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "wb") as f:
        pickle.dump(data, f)
    print(f"Saved {args.out}")


if __name__ == "__main__":
    main()
