"""NSD response and stimulus loading (copy of
``visreps_tpu/data/neural.py:24-228``: the response adapter, the lazy
stimulus brick and ``load_all_nsd_data``).

The ``NSD_STIMULI_HDF5`` environment variable, read when
``load_all_nsd_data`` is called, names the stimulus brick: NSD's HDF5
file, or a ``.npy`` array file of the same (N, H, W, 3) uint8 content.
Unset, the module's ``NSD_STIMULI_HDF5`` default path is used.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Dict

import numpy as np

from visreps_tpu_torch.core.env import get_env_var, load_pickle

logger = logging.getLogger(__name__)

NSD_REGION_MAP = {
    "early visual stream": "early",
    "ventral visual stream": "ventral",
    "V1": "V1",
    "V2": "V2",
    "V3": "V3",
    "hV4": "hV4",
    "FFA": "FFA",
    "PPA": "PPA",
}
NSD_SUBJECTS = list(range(8))

NSD_STIMULI_HDF5 = (
    "/data/shared/datasets/allen2021.natural_scenes/nsddata_stimuli/stimuli/nsd/nsd_stimuli.hdf5")


class ResponseArray:
    """Uniform view over an xarray.DataArray or a plain-dict response set
    ``{"stimulus": [ids], "values": (n_stim, n_voxels)}``."""

    def __init__(self, obj: Any):
        if hasattr(obj, "coords"):  # xarray.DataArray
            self.ids = list(np.asarray(obj.coords["stimulus"].values))
            self._values = np.asarray(obj.values)
        elif isinstance(obj, dict) and "stimulus" in obj:
            self.ids = list(obj["stimulus"])
            self._values = np.asarray(obj["values"])
        else:
            raise TypeError(f"Unsupported response container: {type(obj)}")
        self._index = {str(s): i for i, s in enumerate(self.ids)}

    def sel(self, stim_id) -> np.ndarray:
        return self._values[self._index[str(stim_id)]]


class LazyStimulusBrick:
    """Dict-like on-demand reader over an image brick (the JAX package's
    ``LazyHdf5Dict``): an HDF5 file's ``dataset_name`` (read with h5py),
    or, for a path ending in ``.npy``, a numpy array file opened as a
    memory map (no h5py needed). Keys are the brick's row indices."""

    def __init__(self, path: str, dataset_name: str, indices):
        self._path = str(path)
        self._name = dataset_name
        self._index_map = {str(i): int(i) for i in indices}
        self._keys_sorted = sorted(self._index_map, key=int)
        self._file = None
        self._arr = None

    def _dset(self):
        if self._arr is None:
            if self._path.endswith(".npy"):
                self._arr = np.load(self._path, mmap_mode="r")
            else:
                import h5py

                self._file = h5py.File(self._path, "r")
                self._arr = self._file[self._name]
        return self._arr

    def __contains__(self, key):
        return str(key) in self._index_map

    def __len__(self):
        return len(self._index_map)

    def keys(self):
        return self._keys_sorted

    def __getitem__(self, key):
        k = str(key)
        if k not in self._index_map:
            raise KeyError(key)
        return self._dset()[self._index_map[k]]

    def item_spec(self):
        """(per-item shape, dtype) from the brick's metadata (no data read)."""
        dset = self._dset()
        return tuple(dset.shape[1:]), dset.dtype

    def get_batch(self, keys) -> np.ndarray:
        """One read per contiguous run of rows for a batch of keys
        (h5py fancy indexing is several times slower than run slices)."""
        idxs = np.asarray([self._index_map[str(k)] for k in keys])
        dset = self._dset()
        order = np.argsort(idxs, kind="stable")
        s = idxs[order]
        out = np.empty((len(idxs), *dset.shape[1:]), dset.dtype)
        run_start = 0
        for i in range(1, len(s) + 1):
            if i == len(s) or s[i] != s[i - 1] + 1:
                out[order[run_start:i]] = dset[int(s[run_start]): int(s[i - 1]) + 1]
                run_start = i
        return out

    def close(self):
        self._arr = None
        if self._file is not None:
            self._file.close()
            self._file = None


def load_all_nsd_data(cfg, subjects=None, regions=None) -> Dict:
    """All requested (region, subject) response sets, the lazy stimulus
    brick and the shared-test ids (intersected over
    ``cfg.shared_test_subjects`` when given, else over ``subjects``)."""
    subjects = subjects if subjects is not None else NSD_SUBJECTS
    region_pairs = [(pkl, name) for name, pkl in NSD_REGION_MAP.items()
                    if regions is None or name in regions]
    nsd = load_pickle(os.path.join(get_env_var("NSD_DATA_DIR"), "nsd_data.pkl"))
    shared = set(nsd["shared_ids"])
    test_subjects = cfg.get("shared_test_subjects") if cfg is not None else None

    neural: Dict = {}
    all_ids: set = set()
    per_subject_test: list[set] = []
    for region_key, region_full in region_pairs:
        neural[region_full] = {}
        for subj in subjects:
            arr = ResponseArray(nsd["data"][region_key][subj])
            stim_ids = [int(i) for i in arr.ids]
            all_ids.update(stim_ids)
            train_ids = [str(i) for i in stim_ids if i not in shared]
            test_ids = [str(i) for i in stim_ids if i in shared]
            neural[region_full][subj] = {
                "train": {i: arr.sel(int(i)) for i in train_ids},
                "test": {i: arr.sel(int(i)) for i in test_ids},
            }
            if region_key == region_pairs[0][0]:
                per_subject_test.append(set(test_ids))

    for subj in test_subjects or ():
        if subj in subjects:
            continue
        arr = ResponseArray(nsd["data"][region_pairs[0][0]][subj])
        per_subject_test.append({str(int(i)) for i in arr.ids if int(i) in shared})

    shared_test_ids = sorted(set.intersection(*per_subject_test), key=int)
    brick = os.environ.get("NSD_STIMULI_HDF5", NSD_STIMULI_HDF5)
    stimuli = LazyStimulusBrick(brick, "imgBrick", all_ids)
    logger.info("Loaded NSD: %d subjects x %d regions, %d stimuli, %d shared test IDs",
                len(subjects), len(region_pairs), len(stimuli), len(shared_test_ids))
    return {
        "regions": [f for _, f in region_pairs],
        "subjects": list(subjects),
        "neural": neural,
        "stimuli": stimuli,
        "shared_test_ids": shared_test_ids,
    }
