"""Shared reading of the ``{region}_subj{idx}.npz`` folders."""
from __future__ import annotations

import os

import numpy as np


def region_subject_files(npz_dir: str):
    """(region, subject part, loaded npz) of every ``*_subj*.npz`` file in
    ``npz_dir``, in sorted file-name order; other files are skipped."""
    for fname in sorted(os.listdir(npz_dir)):
        if not fname.endswith(".npz") or "_subj" not in fname:
            continue
        region, subj_part = fname[:-4].rsplit("_subj", 1)
        yield region, subj_part, np.load(os.path.join(npz_dir, fname), allow_pickle=True)
