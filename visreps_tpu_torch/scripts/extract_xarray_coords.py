"""Extract the (class, subclass, stimulus) coordinates of an NSD-Synthetic
betas NetCDF into a sorted, de-duplicated CSV (port of
``scripts/extract_xarray_coords.py``).

Reads the betas DataArray's presentation-aligned ``stimulus``,
``subclass`` and ``class`` coordinates (xarray, imported only here),
keeps each stimulus's first presentation, sorts by (class, subclass,
stimulus) and writes ``class,subclass,stimulus``. The JAX script does
the last three steps with pandas, which the card's machine lacks; this
one writes the CSV as pandas' ``to_csv(index=False)`` does: a header,
``\\n`` line ends, minimal quoting, each value as ``str`` gives it.
Returns the rows written, as (class, subclass, stimulus) tuples.

Usage:
  python -m visreps_tpu_torch.scripts.extract_xarray_coords --input betas.nc \\
      [--output datasets/neural/nsd_synthetic/extracted_coords.csv]
"""
from __future__ import annotations

import argparse
import csv
import os
import sys

COLUMNS = ("class", "subclass", "stimulus")


def extract(nc_path: str, output_csv: str) -> list[tuple]:
    import xarray as xr

    ds = xr.open_dataset(nc_path)
    if "betas" not in ds:
        raise KeyError(f"DataArray 'betas' not found in {nc_path}")
    betas = ds["betas"]
    for coord in ("stimulus", "subclass", "class"):
        if coord not in ds.coords:
            raise KeyError(f"Coordinate '{coord}' not found in {nc_path}")

    columns = [ds[c].sel(presentation=betas.presentation).values for c in COLUMNS]
    rows, seen = [], set()
    for cls, subclass, stimulus in zip(*columns):
        if stimulus not in seen:
            seen.add(stimulus)
            rows.append((cls, subclass, stimulus))
    rows.sort()
    with open(output_csv, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(COLUMNS)
        writer.writerows([[str(v) for v in row] for row in rows])
    print(f"{len(rows)} unique stimuli -> {output_csv}")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True, help="betas .nc file")
    p.add_argument("--output", default="datasets/neural/nsd_synthetic/extracted_coords.csv")
    args = p.parse_args(argv)
    if not os.path.exists(args.input):
        print(f"Error: {args.input} not found", file=sys.stderr)
        sys.exit(1)
    extract(args.input, args.output)


if __name__ == "__main__":
    main()
