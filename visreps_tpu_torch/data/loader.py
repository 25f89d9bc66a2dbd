"""Threaded prefetching loader (copy of ``visreps_tpu/data/loader.py``):
``PrefetchLoader``, ``StimuliDataset`` with its transformed-output cache,
and ``LabeledDataset``, both with the C++ batch decoder
(``visreps_tpu_torch/native``) where it builds.

Batches are assembled in a thread pool (PIL decode and h5py reads
release the GIL) behind a bounded prefetch queue of numpy batches; the
extractor overlaps the host→device copy with compute on top of this.
A dataset's ``native_batch(idxs, n_threads)`` serves a whole batch when
it can, else None and the loader transforms item by item.

``ROUTES`` counts the items every dataset here served, by route:
``cache`` (the transformed-output cache: no decode), ``brick`` (one bulk
read of a uint8 store), ``native`` (the C++ decoder), ``pil`` (per item
from a path, decoded by PIL) and ``array`` (per item from an in-memory
array or image). Callers read it before and after a pass.
"""
from __future__ import annotations

import os
import queue
import threading
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import numpy as np

from visreps_tpu_torch.data.transforms import load_image

#: Items served since import (or since a caller reset it), by route.
ROUTES: Counter = Counter()
_routes_lock = threading.Lock()

_IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png")


def _count(route: str, n: int = 1) -> None:
    with _routes_lock:
        ROUTES[route] += n


def _native():
    """The native decoder module when its library builds, else None."""
    from visreps_tpu_torch import native

    return native if native.native_available() else None


class PrefetchLoader:
    """Iterates (batch_array, metas) with background batch assembly.
    ``dataset`` is indexable, returning (array, meta).

    With ``shuffle`` the n-th pass (counting from 0, every ``iter`` of
    this loader) takes the order ``RandomState(seed + n).permutation``,
    as the JAX package's loader does, so both yield the same batches.
    ``num_workers`` threads transform items, and the native decoder runs
    ``num_workers`` threads per batch.
    """

    def __init__(self, dataset, batch_size: int = 128, num_workers: int = 16,
                 prefetch: int = 4, shuffle: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def _index_order(self) -> np.ndarray:
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        return np.random.RandomState(self.seed + self._epoch).permutation(n)

    def __iter__(self):
        order = self._index_order()
        self._epoch += 1
        batches = [order[i: i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        native_batch = getattr(self.dataset, "native_batch", None)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce(pool):
            try:
                for idxs in batches:
                    if stop.is_set():
                        return
                    out = native_batch(idxs, n_threads=self.num_workers) if native_batch else None
                    if out is None:
                        arrs, keys = zip(*pool.map(self.dataset.__getitem__, idxs))
                        out = (np.stack(arrs), list(keys))
                    q.put(out)
                q.put(None)
            except Exception as e:  # the consumer re-raises it
                q.put(e)

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            t = threading.Thread(target=produce, args=(pool,), daemon=True)
            t.start()
            try:
                while True:
                    item = q.get()
                    if item is None:
                        break
                    if isinstance(item, Exception):
                        raise item
                    yield item
            finally:
                stop.set()
                while t.is_alive():  # unblock a producer waiting on a full queue
                    try:
                        q.get(timeout=0.1)
                    except queue.Empty:
                        pass
                t.join()


def _batch_array_fast(batch: np.ndarray, spec: dict) -> np.ndarray | None:
    """The batched identity-resize fast path: uint8 (B, H, W, 3) whose
    shorter side equals the resize size reduce the transform to a centre
    crop (+ optional normalise), with the per-item path's offsets and
    arithmetic. None when that does not apply."""
    if (spec["augment"] or batch.ndim != 4 or batch.shape[3] != 3
            or batch.dtype != np.uint8):
        return None
    h, w = batch.shape[1:3]
    crop = spec["crop"]
    if min(h, w) != spec["resize"] or h < crop or w < crop:
        return None
    top = int(round((h - crop) / 2.0))
    left = int(round((w - crop) / 2.0))
    out = batch[:, top: top + crop, left: left + crop]
    if not spec.get("normalize", True):
        return np.ascontiguousarray(out)
    mean = np.asarray(spec["mean"], np.float32)
    std = np.asarray(spec["std"], np.float32)
    return (np.asarray(out, np.float32) / 255.0 - mean) / std


def _is_image_path(val) -> bool:
    return isinstance(val, str) and val.lower().endswith(_IMAGE_SUFFIXES)


class StimuliDataset:
    """Sorted-key stimulus dataset over path / ndarray / lazy-store
    values; returns (image, stimulus_id).

    Transformed-output cache: evals that pass over the same stimuli twice
    (THINGS' and TVSD's SRP extraction, then the exact re-extraction of
    the selected layer) would decode every image twice. With a
    deterministic transform, the transformed arrays are kept when the
    whole set fits under ``VISREPS_DECODE_CACHE_MAX`` bytes (default 8e9;
    0 disables): crop² · 3 bytes per item, × 4 when normalised.
    """

    def __init__(self, stimuli, transform):
        self.keys = sorted(stimuli.keys())
        self.stimuli = stimuli
        self.transform = transform
        self._cache: dict | None = None
        spec = getattr(transform, "spec", None)
        if spec is not None and not spec["augment"]:
            bpp = 4 if spec.get("normalize", True) else 1
            est = len(self.keys) * spec["crop"] * spec["crop"] * 3 * bpp
            cap = float(os.environ.get("VISREPS_DECODE_CACHE_MAX", 8e9))
            if 0 < est < cap:
                self._cache = {}

    def __len__(self):
        return len(self.keys)

    @property
    def cache_enabled(self) -> bool:
        return self._cache is not None

    def cache_stats(self) -> dict:
        """Entries and bytes held by the cache (0 and 0 when off)."""
        if self._cache is None:
            return {"entries": 0, "bytes": 0}
        entries = list(self._cache.values())
        return {"entries": len(entries), "bytes": sum(a.nbytes for a in entries)}

    def _fill(self, idxs, batch) -> None:
        if self._cache is not None:
            for j, i in enumerate(idxs):
                self._cache[i] = batch[j]

    def __getitem__(self, idx):
        key = self.keys[idx]
        if self._cache is not None and idx in self._cache:
            _count("cache")
            return self._cache[idx], key
        val = self.stimuli[key]
        out = self.transform(val)
        _count("pil" if isinstance(val, str) else "array")
        if self._cache is not None:
            self._cache[idx] = out
        return out, key

    def native_batch(self, idxs, n_threads: int = 16):
        """A whole batch by the first route that applies: the cache when
        it holds every index; one bulk read of a uint8 store whose items
        are already at the resize size (uint8 feed only); the C++ decoder
        when every stimulus is a JPEG/PNG path. None otherwise (and for
        augmenting transforms): the loader then goes item by item."""
        spec = getattr(self.transform, "spec", None)
        if spec is None or spec["augment"]:
            return None
        idxs = [int(i) for i in idxs]
        if self._cache is not None and all(i in self._cache for i in idxs):
            _count("cache", len(idxs))
            return np.stack([self._cache[i] for i in idxs]), [self.keys[i] for i in idxs]
        keys = [self.keys[i] for i in idxs]
        out = self._brick_batch(keys, spec)
        if out is not None:
            _count("brick", len(idxs))
            self._fill(idxs, out)
            return out, keys
        paths = []
        for key in keys:  # stops at the first value that is not a path: no wasted reads
            val = self.stimuli[key]
            if not _is_image_path(val):
                return None
            paths.append(val)
        native = _native()
        if native is None:
            return None
        if spec.get("normalize", True):
            batch = native.decode_batch(paths, spec["resize"], spec["crop"], spec["mean"],
                                        spec["std"], n_threads=n_threads)
        else:
            batch = native.decode_batch_u8(paths, spec["resize"], spec["crop"],
                                           n_threads=n_threads)
        _count("native", len(idxs))
        self._fill(idxs, batch)
        return batch, keys

    def _brick_batch(self, keys, spec) -> np.ndarray | None:
        """uint8 feed from a bulk-readable store (``get_batch``): one
        run-sliced read and a vectorised centre crop. The store's
        ``item_spec`` (shape, dtype), where it has one, is checked before
        the read, so that a store the fast path declines is not read
        twice. The float feed stays per item, where its normalise
        arithmetic spreads over the threads."""
        get_batch = getattr(self.stimuli, "get_batch", None)
        if get_batch is None or spec.get("normalize", True):
            return None
        item_spec = getattr(self.stimuli, "item_spec", None)
        if item_spec is not None:
            shape, dtype = item_spec()
            crop = spec["crop"]
            if not (len(shape) == 3 and shape[2] == 3 and dtype == np.uint8
                    and min(shape[0], shape[1]) == spec["resize"]
                    and shape[0] >= crop and shape[1] >= crop):
                return None
        return _batch_array_fast(get_batch(keys), spec)


def make_stimuli_loader(stimuli, transform, batch_size: int, num_workers: int = 16) -> PrefetchLoader:
    """In-order loader over a stimulus dict."""
    return PrefetchLoader(StimuliDataset(stimuli, transform), batch_size=batch_size,
                          num_workers=num_workers)


class LabeledDataset:
    """(image, int label) dataset over (path, label, image id) samples."""

    def __init__(self, samples: Sequence, transform: Callable):
        self.samples = list(samples)
        self.transform = transform
        self._native_rng = np.random.RandomState(0)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        path, label, _ = self.samples[idx]
        _count("pil" if isinstance(path, str) else "array")
        return self.transform(load_image(path)), label

    def native_batch(self, idxs, n_threads: int = 16):
        """A batch through the C++ decoder when the library builds, the
        transform normalises, and every path is a JPEG/PNG; else None.
        An augmenting transform takes this route only with
        ``VISREPS_NATIVE_AUGMENT=1``, and then augments by horizontal
        flip alone (p = 0.5 from this dataset's ``RandomState(0)``): the
        ±10° rotation is PIL's only."""
        spec = getattr(self.transform, "spec", None)
        if spec is None or not spec.get("normalize", True):
            return None
        if spec["augment"] and os.environ.get("VISREPS_NATIVE_AUGMENT") != "1":
            return None
        paths, labels = [], []
        for i in idxs:
            path, label, _ = self.samples[i]
            if not _is_image_path(path):
                return None
            paths.append(path)
            labels.append(label)
        native = _native()
        if native is None:
            return None
        hflip = None
        if spec["augment"]:
            hflip = (self._native_rng.rand(len(paths)) < 0.5).astype(np.uint8)
        batch = native.decode_batch(paths, spec["resize"], spec["crop"], spec["mean"],
                                    spec["std"], hflip=hflip, n_threads=n_threads)
        _count("native", len(paths))
        return batch, labels
