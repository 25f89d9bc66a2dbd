"""Neural dataset loaders: NSD, NSD-Synthetic, THINGS, TVSD, Cusack2025
(copy of ``visreps_tpu/data/neural.py``: the response adapter, the lazy
stimulus brick and every loader).

The ``NSD_STIMULI_HDF5`` environment variable, read when an NSD loader
is called, names the stimulus brick: NSD's HDF5 file, or a ``.npy``
array file of the same (N, H, W, 3) uint8 content. Unset, the module's
``NSD_STIMULI_HDF5`` default path is used. NSD-Synthetic reads
``$NSD_SYNTHETIC_DATA_DIR``; THINGS, TVSD and Cusack read pickles under
``datasets/neural/`` relative to the working directory, and TVSD's
images lie under ``$BONNER_DATASETS_HOME/hebart2019.things``.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Dict

import numpy as np

from visreps_tpu_torch.core.env import get_env_var, load_pickle
from visreps_tpu_torch.data.loader import make_stimuli_loader
from visreps_tpu_torch.data.transforms import get_transform

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
TVSD_REGIONS = ["V1", "V4", "IT"]
TVSD_SUBJECTS = [0, 1]

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

    def subset(self, keys) -> "LazyStimulusBrick":
        """A reader over the same brick holding only ``keys``."""
        return LazyStimulusBrick(self._path, self._name, [self._index_map[str(k)] for k in keys])

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


def load_nsd_data(cfg) -> tuple[dict, "LazyStimulusBrick"]:
    """One (region, subject): ({"train"/"test": {sid: response}}, stimuli)."""
    region_key = NSD_REGION_MAP.get(cfg["region"], cfg["region"])
    nsd = load_pickle(os.path.join(get_env_var("NSD_DATA_DIR"), "nsd_data.pkl"))
    shared = set(nsd["shared_ids"])
    arr = ResponseArray(nsd["data"][region_key][cfg["subject_idx"]])
    stim_ids = [int(i) for i in arr.ids]
    targets = {
        "train": {str(i): arr.sel(i) for i in stim_ids if i not in shared},
        "test": {str(i): arr.sel(i) for i in stim_ids if i in shared},
    }
    brick = os.environ.get("NSD_STIMULI_HDF5", NSD_STIMULI_HDF5)
    return targets, LazyStimulusBrick(brick, "imgBrick", stim_ids)


# ── NSD Synthetic ────────────────────────────────────────────────
def load_nsd_synthetic_test_data(cfg, subjects=None, regions=None) -> Dict:
    """The shared synthetic test stimuli (220 in NSD-Synthetic) with every
    requested (region, subject)'s responses to them, and their PNG paths
    under ``$NSD_SYNTHETIC_DATA_DIR/stimuli``."""
    subjects = subjects if subjects is not None else NSD_SUBJECTS
    region_pairs = [(pkl, name) for name, pkl in NSD_REGION_MAP.items()
                    if regions is None or name in regions]
    root = get_env_var("NSD_SYNTHETIC_DATA_DIR")
    synth = load_pickle(os.path.join(root, "nsd_synthetic_data.pkl"))
    names = synth["shared_stimulus_names"]

    neural: Dict = {}
    for region_key, region_full in region_pairs:
        neural[region_full] = {}
        for subj in subjects:
            arr = ResponseArray(synth["data"][region_key][subj])
            neural[region_full][subj] = {s: arr.sel(s) for s in names}

    return {
        "regions": [f for _, f in region_pairs],
        "subjects": list(subjects),
        "neural": neural,
        "stimuli": {n: os.path.join(root, "stimuli", f"{n}.png") for n in names},
        "test_ids": list(names),
    }


def load_nsd_synthetic_data(cfg) -> tuple[dict, dict]:
    """One (region, subject)'s synthetic responses and stimulus arrays."""
    region, subj = cfg["region"], cfg["subject_idx"]
    root = get_env_var("NSD_SYNTHETIC_DATA_DIR")
    fmri = load_pickle(os.path.join(root, "fmri_responses.pkl"))[region][subj]
    images = {str(k): v for k, v in
              load_pickle(os.path.join(root, f"stimuli_subject_{subj}.pkl")).items()}
    ids = {str(k) for k in fmri} & images.keys()
    return {i: fmri[i] for i in ids}, {i: images[i] for i in ids}


# ── THINGS behavioural ───────────────────────────────────────────
def load_things_data() -> tuple[dict, dict]:
    """({"embeddings": {concept: (66,)}, "image_ids": {concept: [ids]}},
    {image id: path}) from ``datasets/neural/things/things_split.pkl``,
    relative to the working directory."""
    data = load_pickle(os.path.join("datasets", "neural", "things", "things_split.pkl"))
    return {"embeddings": data["embeddings"], "image_ids": data["image_ids"]}, data["image_paths"]


# ── TVSD macaque ─────────────────────────────────────────────────
def _tvsd_things_image_path(sid: str, things_root: str) -> str | None:
    """THINGS' layout: images/object_images/<concept>/<sid>.jpg, the
    concept being the id without its last ``_`` field."""
    concept = "_".join(sid.split("_")[:-1])
    path = os.path.join(things_root, "images", "object_images", concept, f"{sid}.jpg")
    if os.path.exists(path):
        return path
    logger.warning("TVSD image not found: %s", path)
    return None


def _things_root() -> str:
    return os.path.join(
        os.environ.get("BONNER_DATASETS_HOME", os.path.expanduser("~/.cache/bonner-datasets")),
        "hebart2019.things")


def load_tvsd_data(cfg) -> tuple[dict, dict]:
    """One (region, monkey): ({split: {sid: response}}, {sid: image path})."""
    region, subj = cfg["region"], cfg["subject_idx"]
    splits = load_pickle(os.path.join("datasets", "neural", "tvsd", "fmri_responses.pkl"))[region][subj]
    root = _things_root()
    targets, img_paths = {}, {}
    for split_name, obj in splits.items():
        arr = ResponseArray(obj)
        ids = [str(s) for s in arr.ids]
        targets[split_name] = {sid: arr.sel(sid) for sid in ids}
        for sid in ids:
            if sid not in img_paths and (p := _tvsd_things_image_path(sid, root)):
                img_paths[sid] = p
    return targets, img_paths


def load_all_tvsd_data(cfg, subjects=None, regions=None) -> Dict:
    """Every requested (region, monkey)'s train/test responses from
    ``datasets/neural/tvsd/fmri_responses.pkl`` (relative to the working
    directory), the image paths, and the test ids shared by the monkeys
    (string ids, sorted as strings)."""
    subjects = subjects if subjects is not None else TVSD_SUBJECTS
    regions_to_load = regions if regions is not None else TVSD_REGIONS
    data = load_pickle(os.path.join("datasets", "neural", "tvsd", "fmri_responses.pkl"))
    root = _things_root()

    neural: Dict = {}
    all_paths: Dict = {}
    per_subject_test: list[set] = []
    for region in regions_to_load:
        neural[region] = {}
        for subj in subjects:
            targets = {}
            for split_name, obj in data[region][subj].items():
                arr = ResponseArray(obj)
                ids = [str(s) for s in arr.ids]
                targets[split_name] = {sid: arr.sel(sid) for sid in ids}
                for sid in ids:
                    if sid not in all_paths and (p := _tvsd_things_image_path(sid, root)):
                        all_paths[sid] = p
            neural[region][subj] = targets
            if region == regions_to_load[0]:
                per_subject_test.append(set(targets["test"]))

    return {
        "regions": list(regions_to_load),
        "subjects": list(subjects),
        "neural": neural,
        "stimuli": all_paths,
        "shared_test_ids": sorted(set.intersection(*per_subject_test)),
    }


# ── Cusack 2025 infant fMRI ──────────────────────────────────────
def load_cusack_data(cfg) -> tuple[dict, dict]:
    """One region and age group's responses and display-image paths from
    ``datasets/neural/cusack2025/`` (relative to the working directory)."""
    region = cfg["region"]
    age_group = cfg.get("age_group", "2month")
    fmri = load_pickle(os.path.join("datasets", "neural", "cusack2025", "fmri_responses.pkl"))
    targets = fmri[region][age_group]
    stimuli_dir = os.path.join("datasets", "neural", "cusack2025", "display_images")
    stimuli = {}
    for sid in targets:
        p = os.path.join(stimuli_dir, f"{sid}.png")
        if not os.path.exists(p):
            raise FileNotFoundError(f"Stimulus image not found: {p}")
        stimuli[sid] = p
    return targets, stimuli


# ── unified entry ────────────────────────────────────────────────
def get_neural_loader(cfg):
    """(targets, loader) for one neural dataset's stimuli; the loader
    ships uint8 batches when ``uint8_transfer`` is set (the extractor
    normalises them on the device)."""
    loaders = {"nsd": load_nsd_data, "things-behavior": lambda cfg: load_things_data(),
               "nsd_synthetic": load_nsd_synthetic_data, "cusack": load_cusack_data,
               "tvsd": load_tvsd_data}
    dataset = cfg.get("neural_dataset")
    if dataset not in loaders:
        raise ValueError(
            "neural_dataset must be 'nsd', 'things-behavior', 'nsd_synthetic', 'cusack', or 'tvsd'")
    targets, stimuli = loaders[dataset](cfg)
    loader = make_stimuli_loader(
        stimuli, get_transform("imgnet", normalize=not cfg.get("uint8_transfer", False)),
        cfg["batchsize"], cfg.get("num_workers", 16))
    return targets, loader
