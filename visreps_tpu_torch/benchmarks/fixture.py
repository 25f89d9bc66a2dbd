"""Synthetic fixtures on disk: NSD, THINGS, TVSD and NSD-Synthetic for
the evals, ImageNet for training.

The NSD fixture is the port of ``ensure_fixture`` in
``visreps_tpu/benchmarks/fixture.py`` (same content, seeds and env
knobs; the JPEG pool is written only by the fixtures that read it):

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

The THINGS, TVSD and NSD-Synthetic fixtures are the ports of
``ensure_things_fixture``, ``ensure_tvsd_fixture`` and
``ensure_nsd_synthetic_fixture`` there (same seeds, ids and layouts):

  * jpeg/ — a pool of ``n_jpeg`` JPEGs (PCG64 seed 2: 64 noise images,
    file i the (i mod 64)-th rolled by i pixels); THINGS and TVSD ids
    point at pool files in turn, so decode work scales with the ids
    while only the pool is written;
  * things_root/datasets/neural/things/things_split.pkl — 66-d concept
    embeddings (seed 3), per-concept image ids and their paths;
    ``load_things_data`` reads it relative to the working directory;
  * tvsd_root/ — datasets/neural/tvsd/fmri_responses.pkl (2 monkeys ×
    V1/V4/IT, seed 4) and bonner/hebart2019.things/images/... symlinks
    into the pool (``BONNER_DATASETS_HOME`` = ``tvsd_root/bonner``);
  * nsd_synthetic/ — nsd_synthetic_data.pkl and stimuli/<name>.png
    (seed 5), read from ``NSD_SYNTHETIC_DATA_DIR``.

Each takes its directory and scale as arguments; left None they take
the ``VISREPS_BENCH_*`` defaults.

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
from typing import Sequence

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
N_JPEG = _env_int("VISREPS_BENCH_N_JPEG", 8192)
THINGS_CONCEPTS = _env_int("VISREPS_BENCH_THINGS_CONCEPTS", 1854)
THINGS_IMGS_PER_CONCEPT = _env_int("VISREPS_BENCH_THINGS_IPC", 14)  # 25,956 images
THINGS_EMB_DIM = 66
TVSD_CONCEPTS = _env_int("VISREPS_BENCH_TVSD_CONCEPTS", 1854)
TVSD_IMGS_PER_CONCEPT = _env_int("VISREPS_BENCH_TVSD_IPC", 12)  # 22,248 train images
TVSD_N_TEST = _env_int("VISREPS_BENCH_TVSD_N_TEST", 100)
TVSD_N_SITES = _env_int("VISREPS_BENCH_TVSD_N_SITES", 256)
NSDSYN_N_STIMULI = _env_int("VISREPS_BENCH_NSDSYN_N", 220)


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


def _meta_matches(meta_path: Path, **expected) -> dict | None:
    """The fixture's meta.json when it records ``expected``, else None."""
    if not meta_path.exists():
        return None
    meta = json.loads(meta_path.read_text())
    return meta if all(meta.get(k) == v for k, v in expected.items()) else None


def ensure_jpeg_pool(fixture_dir: Path, n_jpeg: int, img_size: int) -> list[Path]:
    """The JAX fixture's JPEG pool (``img_{i:05d}.jpg``, i < n_jpeg, under
    ``fixture_dir/jpeg``), written with 8 threads unless present at this
    count and size; returns the files in name order."""
    from PIL import Image

    root = fixture_dir / "jpeg"
    paths = [root / f"img_{i:05d}.jpg" for i in range(n_jpeg)]
    if _meta_matches(root / "meta.json", n_jpeg=n_jpeg, img_size=img_size):
        return paths
    root.mkdir(parents=True, exist_ok=True)
    base = np.random.Generator(np.random.PCG64(2)).integers(
        0, 256, (64, img_size, img_size, 3), dtype=np.uint8)

    def write(i):
        # each file differs a little, so decoders cannot deduplicate them
        arr = np.roll(base[i % 64], shift=i % img_size, axis=1)
        Image.fromarray(arr).save(paths[i], quality=85)

    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(write, range(n_jpeg)))
    (root / "meta.json").write_text(json.dumps({"n_jpeg": n_jpeg, "img_size": img_size}))
    return paths


def ensure_things_fixture(fixture_dir: str | Path | None = None, n_concepts: int | None = None,
                          imgs_per_concept: int | None = None, n_jpeg: int | None = None,
                          img_size: int | None = None) -> dict:
    """THINGS: ``things_split.pkl`` (66-d concept embeddings, per-concept
    image ids ``concept{c:04d}_{i:02d}`` and their pool paths) under
    ``things_root/`` (chdir there: the loader reads a relative path);
    returns its meta ("root", counts, "build_s")."""
    fixture_dir = Path(fixture_dir) if fixture_dir is not None else FIXTURE_DIR
    n_concepts = THINGS_CONCEPTS if n_concepts is None else n_concepts
    ipc = THINGS_IMGS_PER_CONCEPT if imgs_per_concept is None else imgs_per_concept
    n_jpeg = N_JPEG if n_jpeg is None else n_jpeg
    img_size = IMG_SIZE if img_size is None else img_size
    root = fixture_dir / "things_root"
    scale = {"n_concepts": n_concepts, "n_images": n_concepts * ipc, "n_jpeg": n_jpeg,
             "img_size": img_size}
    meta = _meta_matches(root / "meta.json", **scale)
    if meta:
        return meta
    t0 = time.time()
    pool = [str(p) for p in ensure_jpeg_pool(fixture_dir, n_jpeg, img_size)]
    rng = np.random.Generator(np.random.PCG64(3))
    embeddings, image_ids, image_paths = {}, {}, {}
    k = 0
    for c in range(n_concepts):
        concept = f"concept{c:04d}"
        embeddings[concept] = rng.standard_normal(THINGS_EMB_DIM).astype(np.float32)
        image_ids[concept] = [f"{concept}_{i:02d}" for i in range(ipc)]
        for sid in image_ids[concept]:
            image_paths[sid] = pool[k % len(pool)]
            k += 1
    pkl_dir = root / "datasets" / "neural" / "things"
    pkl_dir.mkdir(parents=True, exist_ok=True)
    with open(pkl_dir / "things_split.pkl", "wb") as f:
        pickle.dump({"embeddings": embeddings, "image_ids": image_ids,
                     "image_paths": image_paths}, f, protocol=pickle.HIGHEST_PROTOCOL)
    meta = {"root": str(root), **scale, "build_s": round(time.time() - t0, 1)}
    (root / "meta.json").write_text(json.dumps(meta))
    return meta


def ensure_tvsd_fixture(fixture_dir: str | Path | None = None, n_concepts: int | None = None,
                        imgs_per_concept: int | None = None, n_test: int | None = None,
                        n_sites: int | None = None, n_jpeg: int | None = None,
                        img_size: int | None = None) -> dict:
    """TVSD: ``fmri_responses.pkl`` (2 monkeys × V1/V4/IT, train ids
    ``concept{c:04d}_{i:02d}``, test ids ``testconcept{j:04d}_00``,
    ``n_sites`` responses each) under ``tvsd_root/`` (chdir there), and
    THINGS-layout symlinks into the JPEG pool under ``tvsd_root/bonner``
    (the meta's "bonner_home", for ``BONNER_DATASETS_HOME``)."""
    fixture_dir = Path(fixture_dir) if fixture_dir is not None else FIXTURE_DIR
    n_concepts = TVSD_CONCEPTS if n_concepts is None else n_concepts
    ipc = TVSD_IMGS_PER_CONCEPT if imgs_per_concept is None else imgs_per_concept
    n_test = TVSD_N_TEST if n_test is None else n_test
    n_sites = TVSD_N_SITES if n_sites is None else n_sites
    n_jpeg = N_JPEG if n_jpeg is None else n_jpeg
    img_size = IMG_SIZE if img_size is None else img_size
    root = fixture_dir / "tvsd_root"
    n_train = n_concepts * ipc
    scale = {"n_train": n_train, "n_test": n_test, "n_sites": n_sites, "n_jpeg": n_jpeg,
             "img_size": img_size}
    meta = _meta_matches(root / "meta.json", **scale)
    if meta:
        return meta
    t0 = time.time()
    pool = ensure_jpeg_pool(fixture_dir, n_jpeg, img_size)
    train_ids = [f"concept{c:04d}_{i:02d}" for c in range(n_concepts) for i in range(ipc)]
    test_ids = [f"testconcept{j:04d}_00" for j in range(n_test)]
    objects = root / "bonner" / "hebart2019.things" / "images" / "object_images"
    for k, sid in enumerate(train_ids + test_ids):
        d = objects / "_".join(sid.split("_")[:-1])
        d.mkdir(parents=True, exist_ok=True)
        link = d / f"{sid}.jpg"
        if link.is_symlink() or link.exists():
            link.unlink()
        os.symlink(pool[k % len(pool)], link)

    rng = np.random.Generator(np.random.PCG64(4))
    data = {}
    for region in ("V1", "V4", "IT"):
        data[region] = {}
        for subj in (0, 1):
            data[region][subj] = {
                "train": {"stimulus": list(train_ids),
                          "values": rng.standard_normal((n_train, n_sites)).astype(np.float32)},
                "test": {"stimulus": list(test_ids),
                         "values": rng.standard_normal((n_test, n_sites)).astype(np.float32)},
            }
    pkl_dir = root / "datasets" / "neural" / "tvsd"
    pkl_dir.mkdir(parents=True, exist_ok=True)
    with open(pkl_dir / "fmri_responses.pkl", "wb") as f:
        pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)
    meta = {"root": str(root), "bonner_home": str(root / "bonner"), **scale,
            "build_s": round(time.time() - t0, 1)}
    (root / "meta.json").write_text(json.dumps(meta))
    return meta


def ensure_nsd_synthetic_fixture(fixture_dir: str | Path | None = None,
                                 n_stimuli: int | None = None, n_subjects: int | None = None,
                                 n_regions: int | None = None, n_voxels: int | None = None,
                                 img_size: int | None = None) -> dict:
    """NSD-Synthetic: ``nsd_synthetic_data.pkl`` (``n_stimuli`` shared
    stimuli ``synth{i:03d}`` × subjects × regions) and
    ``stimuli/<name>.png`` under ``nsd_synthetic/`` (the meta's "root",
    for ``NSD_SYNTHETIC_DATA_DIR``)."""
    from PIL import Image

    fixture_dir = Path(fixture_dir) if fixture_dir is not None else FIXTURE_DIR
    n_stimuli = NSDSYN_N_STIMULI if n_stimuli is None else n_stimuli
    n_subjects = N_SUBJECTS if n_subjects is None else n_subjects
    regions = REGIONS if n_regions is None else ALL_REGIONS[:n_regions]
    n_voxels = N_VOXELS if n_voxels is None else n_voxels
    img_size = IMG_SIZE if img_size is None else img_size
    root = fixture_dir / "nsd_synthetic"
    scale = {"n_stimuli": n_stimuli, "n_subjects": n_subjects, "regions": regions,
             "n_voxels": n_voxels, "img_size": img_size}
    meta = _meta_matches(root / "meta.json", **scale)
    if meta:
        return meta
    t0 = time.time()
    stim_dir = root / "stimuli"
    stim_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.Generator(np.random.PCG64(5))
    names = [f"synth{i:03d}" for i in range(n_stimuli)]
    for n in names:
        Image.fromarray(rng.integers(0, 256, (img_size, img_size, 3), dtype=np.uint8)).save(
            stim_dir / f"{n}.png")
    data = {region: {subj: {"stimulus": list(names),
                            "values": rng.standard_normal((n_stimuli, n_voxels)).astype(np.float32)}
                     for subj in range(n_subjects)}
            for region in regions}
    with open(root / "nsd_synthetic_data.pkl", "wb") as f:
        pickle.dump({"shared_stimulus_names": names, "data": data}, f,
                    protocol=pickle.HIGHEST_PROTOCOL)
    meta = {"root": str(root), **scale, "build_s": round(time.time() - t0, 1)}
    (root / "meta.json").write_text(json.dumps(meta))
    return meta


def write_imagenet_fixture(root: str | Path, n_images: int, n_classes: int = 32,
                           pca_n_classes: int | Sequence[int] = 32) -> dict:
    """Write ``n_images`` 256 px JPEGs over ``n_classes`` folders under
    ``root`` (numpy RandomState(0)) and a PCA-label CSV for each of
    ``pca_n_classes``; returns the training config's overrides for them:
    ``dataset_path``, ``label_file`` and an absolute ``pca_labels_folder``."""
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
    for k in [pca_n_classes] if isinstance(pca_n_classes, int) else pca_n_classes:
        with open(pca_dir / f"n_classes_{k}.csv", "w") as f:
            f.write("image,pca_label\n")
            f.writelines(f"{name},{(i % n_classes) % k}\n" for i, name in enumerate(names))
    return {"dataset_path": str(images), "label_file": str(label_file),
            "pca_labels_folder": str(pca_dir)}


def write_tiny_imagenet_fixture(root: str | Path, n_classes: int = 200, n_train: int = 20,
                                n_val: int = 10, img_size: int = 64, seed: int = 0) -> str:
    """Write a Tiny-ImageNet layout under ``root``: ``train/`` and ``val/``
    with one folder per class (``n{k:08d}``) of ``n_train`` and ``n_val``
    JPEGs (numpy RandomState(seed)): a class colour plus 8 × 8 blocks of
    noise, so probes can tell the classes apart. Returns ``root``."""
    from PIL import Image

    root = Path(root).resolve()
    rng = np.random.RandomState(seed)
    colours = rng.randint(0, 256, (n_classes, 3))
    block = 8
    jobs = []
    for split, n in (("train", n_train), ("val", n_val)):
        noise = rng.randint(-48, 49, (n_classes, n, img_size // block, img_size // block, 3))
        for k in range(n_classes):
            folder = root / split / f"n{k:08d}"
            folder.mkdir(parents=True, exist_ok=True)
            jobs.extend((folder / f"{split}_{k}_{i}.JPEG", colours[k], noise[k, i])
                        for i in range(n))

    def write(job):
        path, colour, blocks = job
        px = np.kron(blocks, np.ones((block, block, 1), np.int64)) + colour
        Image.fromarray(np.clip(px, 0, 255).astype(np.uint8)).save(path, quality=90)

    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(write, jobs))
    return str(root)
