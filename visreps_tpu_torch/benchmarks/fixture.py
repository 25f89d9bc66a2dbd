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
``VISREPS_BENCH_*`` variables shrink it, and ``ensure_fixture``'s
arguments override them. The directory is the ``fixture_dir`` argument,
else ``$VISREPS_BENCH_FIXTURE``, else ``visreps_bench_fixture`` under
the system temp directory.

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
ALL_REGIONS = ["early", "ventral", "V1", "V2", "V3", "hV4"]
REGIONS = ALL_REGIONS[: _env_int("VISREPS_BENCH_N_REGIONS", 6)]
N_VOXELS = _env_int("VISREPS_BENCH_N_VOXELS", 512)
N_STIMULI = N_SHARED + N_SUBJECTS * N_UNIQUE
IMG_SIZE = _env_int("VISREPS_BENCH_IMG_SIZE", 256)


def _write_brick(path: Path, n_stimuli: int, img_size: int):
    rng = np.random.Generator(np.random.PCG64(0))
    chunk = 2048  # the JAX writer's draw sizes, so the pixels are identical
    brick = np.lib.format.open_memmap(path, mode="w+", dtype=np.uint8,
                                      shape=(n_stimuli, img_size, img_size, 3))
    for start in range(0, n_stimuli, chunk):
        n = min(chunk, n_stimuli - start)
        brick[start:start + n] = rng.integers(0, 256, (n, img_size, img_size, 3), dtype=np.uint8)
    brick.flush()
    del brick


def _write_pickle(path: Path, n_shared: int, n_unique: int, n_subjects: int, regions: list,
                  n_voxels: int):
    rng = np.random.Generator(np.random.PCG64(1))
    shared_ids = list(range(n_shared))
    data = {}
    for region in regions:
        data[region] = {}
        for subj in range(n_subjects):
            unique = list(range(n_shared + subj * n_unique, n_shared + (subj + 1) * n_unique))
            ids = shared_ids + unique
            data[region][subj] = {
                "stimulus": ids,
                "values": rng.standard_normal((len(ids), n_voxels), dtype=np.float32),
            }
    with open(path, "wb") as f:
        pickle.dump({"shared_ids": shared_ids, "data": data}, f,
                    protocol=pickle.HIGHEST_PROTOCOL)


def ensure_fixture(fixture_dir: str | Path | None = None, n_shared: int | None = None,
                   n_unique: int | None = None, n_subjects: int | None = None,
                   n_regions: int | None = None, n_voxels: int | None = None,
                   img_size: int | None = None) -> dict:
    """Create the fixture in ``fixture_dir`` if absent or at another scale;
    return its paths ("stimuli": the brick, "pickle": the responses) and
    scale. Each argument left None takes the module's value (from the
    ``VISREPS_BENCH_*`` variables), so one process can hold fixtures of
    several scales in several directories."""
    fixture_dir = Path(fixture_dir) if fixture_dir is not None else FIXTURE_DIR
    n_shared = N_SHARED if n_shared is None else n_shared
    n_unique = N_UNIQUE if n_unique is None else n_unique
    n_subjects = N_SUBJECTS if n_subjects is None else n_subjects
    regions = REGIONS if n_regions is None else ALL_REGIONS[:n_regions]
    n_voxels = N_VOXELS if n_voxels is None else n_voxels
    img_size = IMG_SIZE if img_size is None else img_size
    n_stimuli = n_shared + n_subjects * n_unique

    fixture_dir.mkdir(parents=True, exist_ok=True)
    meta_path = fixture_dir / "meta.json"
    brick = fixture_dir / "nsd_stimuli.npy"
    pkl = fixture_dir / "nsd_data.pkl"
    if meta_path.exists() and brick.exists() and pkl.exists():
        meta = json.loads(meta_path.read_text())
        if (meta.get("n_stimuli") == n_stimuli and meta.get("n_subjects") == n_subjects
                and meta.get("regions") == regions
                and meta.get("n_voxels_per_region") == n_voxels
                and meta.get("img_size") == img_size):
            return meta
    t0 = time.time()
    _write_brick(brick, n_stimuli, img_size)
    _write_pickle(pkl, n_shared, n_unique, n_subjects, regions, n_voxels)
    meta = {
        "stimuli": str(brick), "pickle": str(pkl),
        "n_stimuli": n_stimuli, "n_subjects": n_subjects,
        "regions": regions, "n_voxels_per_region": n_voxels,
        "img_size": img_size, "build_s": round(time.time() - t0, 1),
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
