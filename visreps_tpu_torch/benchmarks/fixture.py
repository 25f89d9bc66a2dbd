"""Synthetic NSD fixture on disk (port of ``ensure_fixture`` in
``visreps_tpu/benchmarks/fixture.py``: same content, seeds and env
knobs; the JPEG pool is not written).

  * nsd_stimuli.npy — uint8 (N_STIMULI, IMG_SIZE, IMG_SIZE, 3), the
    pixels of the JAX fixture's HDF5 "imgBrick", stored as a numpy array
    file so that writing and reading it needs no h5py (the data loader
    reads either form);
  * nsd_data.pkl — N_SUBJECTS × regions; each subject sees the N_SHARED
    shared stimuli plus its own N_UNIQUE ones, N_VOXELS float32
    responses per region.

Pixels and responses are random (numpy PCG64 seeds 0 and 1) but flow
through the real loaders. Defaults are the 73k-stimulus NSD scale; the
``VISREPS_BENCH_*`` variables shrink it. The directory is
``$VISREPS_BENCH_FIXTURE``, else ``visreps_bench_fixture`` under the
system temp directory.
"""
from __future__ import annotations

import json
import os
import pickle
import tempfile
import time
from pathlib import Path

import numpy as np

FIXTURE_DIR = Path(os.environ.get(
    "VISREPS_BENCH_FIXTURE", Path(tempfile.gettempdir()) / "visreps_bench_fixture"))


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


N_SHARED = _env_int("VISREPS_BENCH_N_SHARED", 1000)
N_UNIQUE = _env_int("VISREPS_BENCH_N_UNIQUE", 9000)
N_SUBJECTS = _env_int("VISREPS_BENCH_N_SUBJECTS", 8)
REGIONS = ["early", "ventral", "V1", "V2", "V3", "hV4"][: _env_int("VISREPS_BENCH_N_REGIONS", 6)]
N_VOXELS = _env_int("VISREPS_BENCH_N_VOXELS", 512)
N_STIMULI = N_SHARED + N_SUBJECTS * N_UNIQUE
IMG_SIZE = _env_int("VISREPS_BENCH_IMG_SIZE", 256)


def _write_brick(path: Path):
    rng = np.random.Generator(np.random.PCG64(0))
    chunk = 2048  # the JAX writer's draw sizes, so the pixels are identical
    brick = np.lib.format.open_memmap(path, mode="w+", dtype=np.uint8,
                                      shape=(N_STIMULI, IMG_SIZE, IMG_SIZE, 3))
    for start in range(0, N_STIMULI, chunk):
        n = min(chunk, N_STIMULI - start)
        brick[start:start + n] = rng.integers(0, 256, (n, IMG_SIZE, IMG_SIZE, 3), dtype=np.uint8)
    brick.flush()
    del brick


def _write_pickle(path: Path):
    rng = np.random.Generator(np.random.PCG64(1))
    shared_ids = list(range(N_SHARED))
    data = {}
    for region in REGIONS:
        data[region] = {}
        for subj in range(N_SUBJECTS):
            unique = list(range(N_SHARED + subj * N_UNIQUE, N_SHARED + (subj + 1) * N_UNIQUE))
            ids = shared_ids + unique
            data[region][subj] = {
                "stimulus": ids,
                "values": rng.standard_normal((len(ids), N_VOXELS), dtype=np.float32),
            }
    with open(path, "wb") as f:
        pickle.dump({"shared_ids": shared_ids, "data": data}, f,
                    protocol=pickle.HIGHEST_PROTOCOL)


def ensure_fixture() -> dict:
    """Create the fixture if absent or at another scale; return its
    paths ("stimuli": the brick, "pickle": the responses) and scale."""
    FIXTURE_DIR.mkdir(parents=True, exist_ok=True)
    meta_path = FIXTURE_DIR / "meta.json"
    brick = FIXTURE_DIR / "nsd_stimuli.npy"
    pkl = FIXTURE_DIR / "nsd_data.pkl"
    if meta_path.exists() and brick.exists() and pkl.exists():
        meta = json.loads(meta_path.read_text())
        if (meta.get("n_stimuli") == N_STIMULI and meta.get("n_subjects") == N_SUBJECTS
                and meta.get("regions") == REGIONS
                and meta.get("n_voxels_per_region") == N_VOXELS
                and meta.get("img_size") == IMG_SIZE):
            return meta
    t0 = time.time()
    _write_brick(brick)
    _write_pickle(pkl)
    meta = {
        "stimuli": str(brick), "pickle": str(pkl),
        "n_stimuli": N_STIMULI, "n_subjects": N_SUBJECTS,
        "regions": REGIONS, "n_voxels_per_region": N_VOXELS,
        "img_size": IMG_SIZE, "build_s": round(time.time() - t0, 1),
    }
    meta_path.write_text(json.dumps(meta))
    return meta
