"""Threaded prefetching stimulus loader (copy of
``visreps_tpu/data/loader.py``'s ``PrefetchLoader`` / ``StimuliDataset``
without the native C++ decoder: decode runs in threaded PIL/numpy).

Batches are assembled in a thread pool (PIL decode and h5py reads
release the GIL) behind a bounded prefetch queue of numpy batches; the
extractor overlaps the host→device copy with compute on top of this.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class PrefetchLoader:
    """Iterates (batch_array, keys) in dataset order with background
    batch assembly. ``dataset`` is indexable, returning (array, key)."""

    def __init__(self, dataset, batch_size: int = 128, num_workers: int = 16,
                 prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        n = len(self.dataset)
        batches = [range(i, min(i + self.batch_size, n)) for i in range(0, n, self.batch_size)]
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce(pool):
            try:
                for idxs in batches:
                    if stop.is_set():
                        return
                    out = self.dataset.get_batch(idxs) if hasattr(self.dataset, "get_batch") else None
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


class StimuliDataset:
    """Sorted-key stimulus dataset over path / ndarray / lazy-HDF5 values;
    returns (image, stimulus_id)."""

    def __init__(self, stimuli, transform):
        self.keys = sorted(stimuli.keys())
        self.stimuli = stimuli
        self.transform = transform

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, idx):
        key = self.keys[idx]
        return self.transform(self.stimuli[key]), key

    def get_batch(self, idxs):
        """uint8 feed from a bulk-readable store (the HDF5 brick) whose
        items are already 256 px: one run-sliced read for the batch and
        a vectorised centre crop. None when that does not apply."""
        spec = self.transform.spec
        store_batch = getattr(self.stimuli, "get_batch", None)
        if store_batch is None or spec["normalize"]:
            return None
        shape, dtype = self.stimuli.item_spec()
        crop = spec["crop"]
        if not (len(shape) == 3 and shape[2] == 3 and dtype == np.uint8
                and min(shape[0], shape[1]) == spec["resize"]
                and shape[0] >= crop and shape[1] >= crop):
            return None
        keys = [self.keys[i] for i in idxs]
        batch = store_batch(keys)
        top = int(round((shape[0] - crop) / 2.0))
        left = int(round((shape[1] - crop) / 2.0))
        return np.ascontiguousarray(batch[:, top: top + crop, left: left + crop]), keys


def make_stimuli_loader(stimuli, transform, batch_size: int, num_workers: int = 16) -> PrefetchLoader:
    """In-order loader over a stimulus dict."""
    return PrefetchLoader(StimuliDataset(stimuli, transform), batch_size=batch_size,
                          num_workers=num_workers)
