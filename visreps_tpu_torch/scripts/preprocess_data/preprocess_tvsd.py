"""Build TVSD fmri_responses.pkl (macaque MUA on THINGS stimuli; port of
``scripts/preprocess_data/preprocess_tvsd.py``).

Input: per-(region, subject) files ``{region}_subj{idx}.npz`` with
``train_stimulus``, ``train_values`` (n_train, sites), ``test_stimulus``
and ``test_values``, either (n_test, reps, sites) or flat (n_test · reps,
sites) with ``test_repeats`` (30 when absent). The train split keeps the
single-shot responses; the test split is averaged over its repetitions
(flat: the first n_test ids). Output: data[region][subject] = {"train":
{"stimulus", "values"}, "test": {...}}.

Usage:
  python -m visreps_tpu_torch.scripts.preprocess_data.preprocess_tvsd \\
      --npz-dir mua/ [--out datasets/neural/tvsd/fmri_responses.pkl]
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from visreps_tpu_torch.scripts.preprocess_data._npz import region_subject_files


def _average_test(z) -> tuple[list, np.ndarray]:
    stim = [str(s) for s in z["test_stimulus"]]
    vals = z["test_values"].astype(np.float32)
    if vals.ndim == 3:  # (n_test, n_reps, sites)
        return stim, vals.mean(axis=1)
    reps = int(z["test_repeats"]) if "test_repeats" in z else 30
    n_test = vals.shape[0] // reps
    vals = vals.reshape(n_test, reps, -1).mean(axis=1)
    return stim[:n_test], vals


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--npz-dir", required=True)
    parser.add_argument("--out", default="datasets/neural/tvsd/fmri_responses.pkl")
    args = parser.parse_args(argv)

    data: dict = {}
    for region, subj_part, z in region_subject_files(args.npz_dir):
        test_stim, test_vals = _average_test(z)
        data.setdefault(region, {})[int(subj_part)] = {
            "train": {
                "stimulus": [str(s) for s in z["train_stimulus"]],
                "values": z["train_values"].astype(np.float32),
            },
            "test": {"stimulus": test_stim, "values": test_vals},
        }
        print(f"  {region} subj {subj_part}: train {z['train_values'].shape}, "
              f"test {test_vals.shape} (rep-averaged)")

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "wb") as f:
        pickle.dump(data, f)
    print(f"Saved {args.out}")


if __name__ == "__main__":
    main()
