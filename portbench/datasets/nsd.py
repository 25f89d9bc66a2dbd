"""The NSD dataset of a traffic mix: its fixture on disk, in the layout the
port's NSD loaders read, the eval's data keys, and the view of it that
the reference reads.

The fixture is a frozen copy of ``ensure_fixture`` in
``visreps_tpu_torch/benchmarks/fixture.py`` (the same files, ids and
layout: ``nsd_stimuli.npy``, uint8 (N, 256, 256, 3), read through
``NSD_STIMULI_HDF5``; ``nsd_data.pkl`` under ``NSD_DATA_DIR``: the shared
ids, and per region key and subject the stimulus ids and float32
responses; shared stimuli first, then each subject's own), with one
change: pixels and responses carry a planted signal instead of being
independent noise, so that an RDM is not crowded with near-ties and the
layer selection is decided by margins wider than rounding.

Each stimulus i has a latent z_i ∈ R^K (K = ``signal.latents``). Its
pixels are 128 + ``signal.pixel_amp`` · Σ_k z_ik P_k + uniform integer
noise in ±``signal.pixel_noise``, clipped to [0, 255], where P_k is a
random colour field of grid 2^(1 + k mod 5) upsampled bilinearly to the
image (unit variance): coarse and fine patterns side by side. Region j's
responses mix all the latents through a region matrix (plus a
per-subject part) and add unit noise scaled by ``signal.voxel_noise``,
so that every region's RDM follows the pixels' and the early taps win
the selection by margins that do not hang on the seed's weights (the
phase-2 work then does not either). Everything is drawn
from fixed PCG64 seeds, not from ``--seed``: a checkout writes the files
once and every run reads them.

A dataset file gives ``ensure(cell, directory)`` (the fixture; returns
the environment that points the port at it), ``n_stimuli(cell)`` (the
stimuli an eval processes), ``overrides(cell)`` (the eval's data keys),
``warmup_overrides(cell)`` (the cut of them that the set-up's warm-up
eval runs) and ``View(cell, device)`` (what the reference reads).
"""
from __future__ import annotations

import json
import os
import pickle
from pathlib import Path

import numpy as np

#: The port's NSD region names → the response pickle's keys (a copy of
#: ``visreps_tpu_torch/data/neural.NSD_REGION_MAP``).
REGION_KEYS = {
    "early visual stream": "early",
    "ventral visual stream": "ventral",
    "V1": "V1", "V2": "V2", "V3": "V3", "hV4": "hV4", "FFA": "FFA", "PPA": "PPA",
}

_CHUNK = 256


#: Bumped whenever the bytes written for the same spec change.
FORMAT = 2


def spec_of(traffic: dict) -> dict:
    """What decides the fixture's bytes: the writer's format and part of
    the traffic mix."""
    keys = ("n_shared", "n_unique", "subjects", "regions", "n_voxels", "img_size", "signal")
    return {"format": FORMAT, **{k: traffic[k] for k in keys}}


def n_stimuli(traffic: dict) -> int:
    return traffic["n_shared"] + len(traffic["subjects"]) * traffic["n_unique"]


def voxels_of(traffic: dict) -> list[int]:
    v = traffic["n_voxels"]
    return list(v) if isinstance(v, list) else [int(v)] * len(traffic["regions"])


def _patterns(k: int, size: int) -> np.ndarray:
    """(K, size·size·3) float32 unit-variance colour fields."""
    import torch
    import torch.nn.functional as F

    rng = np.random.Generator(np.random.PCG64(11))
    out = np.empty((k, size * size * 3), np.float32)
    for i in range(k):
        grid = 2 ** (1 + i % 5)
        low = torch.from_numpy(rng.standard_normal((1, 3, grid, grid), dtype=np.float32))
        field = F.interpolate(low, size=(size, size), mode="bilinear", align_corners=False)
        field = field[0].permute(1, 2, 0).reshape(-1).numpy()
        out[i] = (field - field.mean()) / field.std()
    return out


def _latents(n: int, k: int) -> np.ndarray:
    return np.random.Generator(np.random.PCG64(10)).standard_normal((n, k), dtype=np.float32)


def _write_brick(path: Path, z: np.ndarray, size: int, signal: dict) -> None:
    pats = _patterns(z.shape[1], size)
    rng = np.random.Generator(np.random.PCG64(12))
    noise = int(signal["pixel_noise"])
    brick = np.lib.format.open_memmap(path, mode="w+", dtype=np.uint8,
                                      shape=(z.shape[0], size, size, 3))
    for start in range(0, z.shape[0], _CHUNK):
        zc = z[start:start + _CHUNK]
        pix = 128.0 + float(signal["pixel_amp"]) * (zc @ pats)
        pix += rng.integers(-noise, noise + 1, pix.shape, dtype=np.int16)
        brick[start:start + len(zc)] = np.clip(np.rint(pix), 0, 255).astype(np.uint8).reshape(
            len(zc), size, size, 3)
    brick.flush()
    del brick


def _responses(traffic: dict, z: np.ndarray) -> dict:
    n_shared, n_unique = traffic["n_shared"], traffic["n_unique"]
    regions, k = traffic["regions"], z.shape[1]
    signal = traffic["signal"]
    shared = list(range(n_shared))
    data = {}
    for j, (region, n_vox) in enumerate(zip(regions, voxels_of(traffic))):
        mix = np.random.Generator(np.random.PCG64([13, j])).standard_normal(
            (k, n_vox), dtype=np.float32) / np.float32(np.sqrt(k))
        key = REGION_KEYS[region]
        data[key] = {}
        for s, subj in enumerate(traffic["subjects"]):
            ids = shared + list(range(n_shared + s * n_unique, n_shared + (s + 1) * n_unique))
            rng = np.random.Generator(np.random.PCG64([14, j, subj]))
            m = mix + 0.5 * rng.standard_normal(mix.shape, dtype=np.float32)
            values = z[ids] @ m
            values += float(signal["voxel_noise"]) * rng.standard_normal(values.shape,
                                                                         dtype=np.float32)
            data[key][subj] = {"stimulus": ids, "values": values.astype(np.float32)}
    return {"shared_ids": shared, "data": data}


def ensure(traffic: dict, directory: Path) -> dict:
    """Write the mix's fixture into ``directory`` unless it holds this
    spec already; return the environment that points the port's NSD
    loaders at it."""
    directory.mkdir(parents=True, exist_ok=True)
    brick, pkl, meta = directory / "nsd_stimuli.npy", directory / "nsd_data.pkl", \
        directory / "meta.json"
    spec = spec_of(traffic)
    out = {"NSD_STIMULI_HDF5": str(brick), "NSD_DATA_DIR": str(directory)}
    if meta.exists() and brick.exists() and pkl.exists():
        if json.loads(meta.read_text()) == spec:
            return out
    meta.unlink(missing_ok=True)
    z = _latents(n_stimuli(traffic), int(traffic["signal"]["latents"]))
    tmp = directory / "nsd_stimuli.partial.npy"
    _write_brick(tmp, z, int(traffic["img_size"]), traffic["signal"])
    os.replace(tmp, brick)
    with open(directory / "nsd_data.partial.pkl", "wb") as f:
        pickle.dump(_responses(traffic, z), f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(directory / "nsd_data.partial.pkl", pkl)
    meta.write_text(json.dumps(spec))
    return out


def load(directory: Path) -> tuple[np.ndarray, dict]:
    """(the brick as a read-only memory map, the response pickle)."""
    with open(directory / "nsd_data.pkl", "rb") as f:
        data = pickle.load(f)
    return np.load(directory / "nsd_stimuli.npy", mmap_mode="r"), data


def overrides(cell: dict) -> dict:
    """The eval's data keys."""
    return {"neural_dataset": "nsd", "region": list(cell["regions"]),
            "subject_idx": list(cell["subjects"])}


def warmup_overrides(cell: dict) -> dict:
    """The warm-up eval: the first subject alone. It runs every shape of
    the cell's eval (its batches, the selection's n_select rows, the
    exact taps of the shared test stimuli, the scoring) on two thirds of
    a two-subject mix's stimuli."""
    return {"subject_idx": [cell["subjects"][0]]}


MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
CROP = 224


class View:
    """What the reference reads of the fixture: per (region, subject)
    pair its train and test responses by stimulus id (as strings), the
    shared test ids in id order, every stimulus id of the mix sorted as
    strings (the loader's key order), and the stimuli's pixels as the
    eval's transform makes them."""

    def __init__(self, cell: dict, device):
        import torch

        self.device = torch.device(device)
        self.brick, data = load(Path(cell["fixture_dir"]))
        self.regions = list(cell["regions"])
        self.subjects = list(cell["subjects"])
        self.pairs = [(r, s) for r in self.regions for s in self.subjects]
        shared = set(data["shared_ids"])
        self.train, self.test, all_ids = {}, {}, set()
        for r in self.regions:
            for s in self.subjects:
                resp = data["data"][REGION_KEYS[r]][s]
                ids = [int(i) for i in resp["stimulus"]]
                all_ids.update(ids)
                vals = np.asarray(resp["values"], np.float32)
                self.train[(r, s)] = {str(i): vals[j] for j, i in enumerate(ids)
                                      if i not in shared}
                self.test[(r, s)] = {str(i): vals[j] for j, i in enumerate(ids) if i in shared}
        test_sets = [set(self.test[(self.regions[0], s)]) for s in self.subjects]
        self.test_ids = sorted(set.intersection(*test_sets), key=int)
        self.order = sorted(str(i) for i in all_ids)

    def images(self, ids):
        """(B, 3, 224, 224) f32: the centre crop of each stimulus, scaled
        to [0, 1] and normalised by ImageNet's mean and std."""
        import torch

        top = (self.brick.shape[1] - CROP) // 2
        left = (self.brick.shape[2] - CROP) // 2
        rows = np.stack([self.brick[int(i), top:top + CROP, left:left + CROP] for i in ids])
        x = torch.from_numpy(rows).to(self.device).to(torch.float32)
        mean = torch.tensor(MEAN, dtype=torch.float32).to(self.device)
        std = torch.tensor(STD, dtype=torch.float32).to(self.device)
        x = (x / 255.0 - mean) / std
        return x.permute(0, 3, 1, 2)
