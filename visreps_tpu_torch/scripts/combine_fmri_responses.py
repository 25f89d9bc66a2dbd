"""Merge two fMRI response pickles (ROI-keyed dicts) into one (port of
``scripts/combine_fmri_responses.py``): the NSD pRF-ROI pickle and the
streams-ROI pickle become one fmri_responses.pkl over every region key.
The second file's keys win on a collision.

Usage:
  python -m visreps_tpu_torch.scripts.combine_fmri_responses \\
      [--first A.pkl] [--second B.pkl] [--output OUT.pkl]
"""
from __future__ import annotations

import argparse
import pickle


def combine(path1: str, path2: str, output: str) -> dict:
    with open(path1, "rb") as f:
        data1 = pickle.load(f)
    with open(path2, "rb") as f:
        data2 = pickle.load(f)
    print(f"{path1}: {sorted(data1)}")
    print(f"{path2}: {sorted(data2)}")
    combined = {**data1, **data2}
    with open(output, "wb") as f:
        pickle.dump(combined, f)
    print(f"Combined ({sorted(combined)}) -> {output}")
    return combined


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--first", default="datasets/neural/nsd/fmri_responses.pkl")
    p.add_argument("--second", default="datasets/neural/nsd_streams/fmri_responses.pkl")
    p.add_argument("--output", default="datasets/neural/nsd/fmri_responses_combined.pkl")
    args = p.parse_args(argv)
    combine(args.first, args.second, args.output)


if __name__ == "__main__":
    main()
