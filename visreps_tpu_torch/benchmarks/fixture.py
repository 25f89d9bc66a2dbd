"""Synthetic fixtures on disk: NSD for the eval, ImageNet for training.

The NSD fixture is the port of ``ensure_fixture`` in
``visreps_tpu/benchmarks/fixture.py`` (same content, seeds and env
knobs; the JPEG pool is not written):

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

``write_imagenet_fixture`` writes an ImageNet in the layout training
reads (``data/obj_cls.py``): flat ``n0000000k/`` folders of 256 px JPEGs,
each class a colour with blocky noise, ``folder_labels.json`` and a
PCA-label CSV ``pca_labels/n_classes_{K}.csv`` that gives class k the
PCA label k mod K.
"""
from __future__ import annotations

import json
import os
import pickle
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
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


def write_imagenet_fixture(root: str | Path, n_images: int, n_classes: int = 32,
                           pca_n_classes: int = 32) -> dict:
    """Write ``n_images`` 256 px JPEGs over ``n_classes`` folders under
    ``root`` (numpy RandomState(0)); returns the training config's
    overrides for them: ``dataset_path``, ``label_file`` and an absolute
    ``pca_labels_folder``."""
    from PIL import Image

    root = Path(root).resolve()
    images = root / "images"
    pca_dir = root / "pca_labels"
    pca_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(0)
    colours = rng.randint(0, 256, (n_classes, 3))
    wnids = [f"n{k:08d}" for k in range(n_classes)]
    for wnid in wnids:
        (images / wnid).mkdir(parents=True, exist_ok=True)
    block = 16  # noise in 16 × 16 blocks keeps the JPEGs small and fast to decode
    noise = rng.randint(-40, 41, (n_images, 256 // block, 256 // block, 3))
    names = [f"{wnids[i % n_classes]}_{i}.JPEG" for i in range(n_images)]

    def write(i):
        px = np.kron(noise[i], np.ones((block, block, 1), np.int64)) + colours[i % n_classes]
        Image.fromarray(np.clip(px, 0, 255).astype(np.uint8)).save(
            images / wnids[i % n_classes] / names[i], quality=90)

    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(write, range(n_images)))
    label_file = root / "folder_labels.json"
    label_file.write_text(json.dumps({w: k for k, w in enumerate(wnids)}))
    with open(pca_dir / f"n_classes_{pca_n_classes}.csv", "w") as f:
        f.write("image,pca_label\n")
        f.writelines(f"{name},{(i % n_classes) % pca_n_classes}\n"
                     for i, name in enumerate(names))
    return {"dataset_path": str(images), "label_file": str(label_file),
            "pca_labels_folder": str(pca_dir)}
