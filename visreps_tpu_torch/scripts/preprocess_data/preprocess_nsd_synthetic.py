"""Build nsd_synthetic_data.pkl (the shared out-of-distribution stimuli,
subjects × ROIs; port of ``scripts/preprocess_data/
preprocess_nsd_synthetic.py``).

The ``convert`` and ``from-npz`` paths of ``preprocess_nsd``, with the
stimulus NAMES (strings) as ids: ``shared_stimulus_names`` is the sorted
intersection of every file's names. The stimuli themselves are PNGs
under ``$NSD_SYNTHETIC_DATA_DIR/stimuli/{name}.png``.

Usage:
  python -m visreps_tpu_torch.scripts.preprocess_data.preprocess_nsd_synthetic \\
      from-npz --npz-dir betas/ --out nsd_synthetic_data.pkl
"""
from __future__ import annotations

import argparse
import pickle

import numpy as np

from visreps_tpu_torch.scripts.preprocess_data._npz import region_subject_files


def convert_reference_pickle(in_path: str, out_path: str) -> None:
    with open(in_path, "rb") as f:
        synth = pickle.load(f)
    data = {}
    for region, by_subj in synth["data"].items():
        data[region] = {}
        for subj, xr_arr in by_subj.items():
            data[region][subj] = {
                "stimulus": [str(s) for s in np.asarray(xr_arr.coords["stimulus"].values)],
                "values": np.asarray(xr_arr.values, np.float32),
            }
    out = {
        "shared_stimulus_names": [str(s) for s in synth["shared_stimulus_names"]],
        "data": data,
    }
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    print(f"Converted {in_path} -> {out_path}")


def build_from_npz(npz_dir: str, out_path: str) -> None:
    data: dict = {}
    names = None
    for region, subj_part, z in region_subject_files(npz_dir):
        stim = [str(s) for s in z["stimulus"]]
        data.setdefault(region, {})[int(subj_part)] = {
            "stimulus": stim, "values": z["values"].astype(np.float32),
        }
        names = sorted(set(stim) if names is None else set(names) & set(stim))
    with open(out_path, "wb") as f:
        pickle.dump({"shared_stimulus_names": sorted(names or []), "data": data}, f)
    print(f"Saved {out_path}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("convert")
    c.add_argument("input")
    c.add_argument("output")
    b = sub.add_parser("from-npz")
    b.add_argument("--npz-dir", required=True)
    b.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    if args.cmd == "convert":
        convert_reference_pickle(args.input, args.output)
    else:
        build_from_npz(args.npz_dir, args.out)


if __name__ == "__main__":
    main()
