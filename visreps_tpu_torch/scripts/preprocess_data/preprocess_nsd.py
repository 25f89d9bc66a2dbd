"""Build nsd_data.pkl (subjects × ROIs) in the evals' plain-dict format
(port of ``scripts/preprocess_data/preprocess_nsd.py``).

  * ``convert IN OUT``: a reference-format pickle, whose responses are
    xarray DataArrays, to {"shared_ids": {int}, "data": {region:
    {subject: {"stimulus": [int], "values": (n, v) float32}}}}. Only
    ``.coords["stimulus"].values`` and ``.values`` are read, so any
    object with those attributes serves; unpickling the reference's file
    itself needs xarray installed.
  * ``from-npz --npz-dir D --shared-ids F --out OUT``: the same pickle
    from per-(region, subject) files ``{region}_subj{idx}.npz`` holding
    ``stimulus`` and ``values`` (repetition-averaged betas) and a
    ``shared_ids.npy``.

Usage:
  python -m visreps_tpu_torch.scripts.preprocess_data.preprocess_nsd \\
      from-npz --npz-dir betas/ --shared-ids shared_ids.npy --out nsd_data.pkl
"""
from __future__ import annotations

import argparse
import pickle

import numpy as np

from visreps_tpu_torch.scripts.preprocess_data._npz import region_subject_files


def convert_reference_pickle(in_path: str, out_path: str) -> None:
    with open(in_path, "rb") as f:
        nsd = pickle.load(f)
    data = {}
    for region, by_subj in nsd["data"].items():
        data[region] = {}
        for subj, xr_arr in by_subj.items():
            data[region][subj] = {
                "stimulus": [int(s) for s in np.asarray(xr_arr.coords["stimulus"].values)],
                "values": np.asarray(xr_arr.values, np.float32),
            }
    out = {"shared_ids": set(int(s) for s in nsd["shared_ids"]), "data": data}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    print(f"Converted {in_path} -> {out_path}")


def build_from_npz(npz_dir: str, shared_ids_path: str, out_path: str) -> None:
    shared_ids = set(int(s) for s in np.load(shared_ids_path))
    data: dict = {}
    for region, subj_part, z in region_subject_files(npz_dir):
        subj = int(subj_part)
        data.setdefault(region, {})[subj] = {
            "stimulus": [int(s) for s in z["stimulus"]],
            "values": z["values"].astype(np.float32),
        }
        print(f"  {region} subj {subj}: {z['values'].shape}")
    with open(out_path, "wb") as f:
        pickle.dump({"shared_ids": shared_ids, "data": data}, f)
    print(f"Saved {out_path}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("convert", help="reference xarray pickle -> plain-dict pickle")
    c.add_argument("input")
    c.add_argument("output")
    b = sub.add_parser("from-npz", help="assemble from per-(region,subject) npz files")
    b.add_argument("--npz-dir", required=True)
    b.add_argument("--shared-ids", required=True)
    b.add_argument("--out", required=True)
    args = parser.parse_args(argv)

    if args.cmd == "convert":
        convert_reference_pickle(args.input, args.output)
    else:
        build_from_npz(args.npz_dir, args.shared_ids, args.out)


if __name__ == "__main__":
    main()
