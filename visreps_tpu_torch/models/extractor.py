"""Multi-tap activation extraction with on-device SRP (port of
``visreps_tpu/models/extractor.py:34-140, 505-934, 1041-1066``).

One forward per batch captures every tap; each tap is flattened in
(H, W, C) order (the JAX package's NHWC order; ViT's (B, tokens, dim)
taps token-major) and projected by the seeded SRP on the device, one tap
at a time: a tap's flattened copy is dropped before the next is made.
Exact taps are written straight into their store rows. uint8 batches are
normalised on the device, after a pinned, non-blocking host→device copy.

``get_activations`` opens one ``extractor.batch`` span a batch
(``core.profiling.span``), holding ``loader_wait``, ``extractor.h2d``,
``extractor.forward`` (the exact passes open these three too),
``extractor.srp_product`` (with ``srp.draw`` inside where a matrix is
drawn, ``ops/srp.py``) and ``extractor.store``; the probe forward is
``extractor.probe``. The spans are named for this module, whichever
phase calls it.

Under a ``mesh`` (``parallel/``, one process per GPU) every rank reads
the same batches, runs its rows of each (the evals round the batch size
up to a multiple of the 'data' axis, ``parallel.shard.mesh_batch_size``)
and all-gathers the SRP
rows, or the raw taps of the exact passes, in global order, so every
rank holds the single-process store (the JAX package's
``extract_sharded_batch`` route, ``extractor.py:76-92, 323-331``).
"""
from __future__ import annotations

from typing import Iterable, Iterator, Sequence

import numpy as np
import torch
from torch import nn

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.core.profiling import span
from visreps_tpu_torch.data.transforms import DS_MEAN, DS_STD
from visreps_tpu_torch.device import resolve_device
from visreps_tpu_torch.ops.srp import SRPTransform
from visreps_tpu_torch.parallel.shard import extract_sharded_batch


def expand_return_nodes(tap_specs: dict, return_nodes: Sequence[str],
                        extract_pre_and_post: bool = True):
    """Semantic layer names → (ordered tap points, {point: output name}).

    With extract_pre_and_post each layer with a downstream activation
    expands to (name_pre, name_post); without it the post point is
    reported under the plain layer name.
    """
    points: list[str] = []
    alias: dict[str, str] = {}
    for name in return_nodes:
        if name not in tap_specs:
            rprint(f"Warning: {name} not found in model tap map", style="warning")
            continue
        spec = tap_specs[name]
        if extract_pre_and_post or len(spec) == 1:
            for p in spec:
                points.append(p)
                alias[p] = p
        else:
            points.append(spec[-1])
            alias[spec[-1]] = name
    return points, alias


def _batches(loader: Iterable) -> Iterator:
    """The loader's batches; each wait on it is a ``loader_wait`` span."""
    it = iter(loader)
    while True:
        with span("loader_wait"):
            item = next(it, None)
        if item is None:
            return
        yield item


def _flatten_hwc(t: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, H·W·C); (B, T, D) → (B, T·D); (B, D) unchanged."""
    if t.dim() == 4:
        t = t.permute(0, 2, 3, 1)
    return t.reshape(t.shape[0], -1)


def _write_hwc(rows: torch.Tensor, t: torch.Tensor) -> None:
    """Copy tap ``t`` into ``rows`` (B, D) in ``_flatten_hwc``'s order,
    without a flattened temporary."""
    if t.dim() == 4:
        b, c, h, w = t.shape
        rows.view(b, h, w, c).copy_(t.permute(0, 2, 3, 1))
    else:
        rows.copy_(t.reshape(t.shape[0], -1))


class FeatureExtractor:
    """All-tap forward + SRP per batch, on ``device`` (CUDA unless
    ``"cpu"`` is asked for); each batch's rows split over ``mesh``'s
    'data' axis when one is given."""

    def __init__(self, model: nn.Module, return_nodes: Sequence[str],
                 extract_pre_and_post: bool = True, srp_k: int = 4096,
                 srp_seed: int = 0, image_size: int = 224,
                 device: str | torch.device | None = None, mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.model = model.to(self.device).eval()
        self.image_size = image_size
        self.points, self.alias = expand_return_nodes(
            model.TAPS, list(return_nodes), extract_pre_and_post)
        self.srp = SRPTransform(k=srp_k, seed=srp_seed, device=self.device)
        self._mean = torch.as_tensor(DS_MEAN["imgnet"], device=self.device)
        self._std = torch.as_tensor(DS_STD["imgnet"], device=self.device)
        with torch.inference_mode(), span("extractor.probe"):
            probe = torch.zeros((1, 3, image_size, image_size), device=self.device)
            _, taps = self.model(probe, capture=self.points)
        self.tap_dims = {self.alias[p]: taps[p][0].numel() for p in self.points}

    def out_dims(self) -> dict[str, int]:
        return {name: self.srp.out_dim(d) for name, d in self.tap_dims.items()}

    def _sharded(self, fn, x: np.ndarray) -> dict[str, torch.Tensor]:
        """``fn`` of one host batch: on this rank's rows, all-gathered,
        under a mesh; on the whole batch otherwise."""
        return fn(x) if self.mesh is None else extract_sharded_batch(fn, x, self.mesh)

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        """(B, H, W, 3) uint8 or normalised float32 batch → (B, 3, H, W)
        float32 on the device; uint8 is normalised there."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        with span("extractor.h2d"):
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            if t.dtype == torch.uint8:
                t = (t.to(torch.float32) / 255.0 - self._mean) / self._std
            return t.to(torch.float32).permute(0, 3, 1, 2)

    def _forward(self, rows: np.ndarray, points) -> dict[str, torch.Tensor]:
        """The raw taps of host rows (this rank's under a mesh)."""
        t = self._to_device(rows)
        with span("extractor.forward"):
            return self.model(t, capture=points)[1]

    def _taps(self, x: np.ndarray, points) -> dict[str, torch.Tensor]:
        """The raw taps of one host batch."""
        return self._sharded(lambda rows: self._forward(rows, points), x)

    def _srp_rows(self, x: np.ndarray) -> dict[str, torch.Tensor]:
        """The SRP rows of every tap of one host batch (under a mesh each
        rank's rows, projected, then all-gathered)."""

        def project(taps: dict) -> dict[str, torch.Tensor]:
            with span("extractor.srp_product"):
                return self._project(taps)

        if self.mesh is None:
            return project(self._taps(x, self.points))
        return extract_sharded_batch(lambda rows: project(self._forward(rows, self.points)),
                                     x, self.mesh)

    def _point_of(self, layer: str) -> str:
        for p in self.points:
            if self.alias[p] == layer or p == layer:
                return p
        raise KeyError(f"Layer {layer!r} not among extraction points {self.points}")

    def _project(self, taps: dict) -> dict[str, torch.Tensor]:
        """{tap name: (B, k) float32 SRP rows} of one batch's raw taps, each
        raw tap released as its projection is made."""
        return {self.alias[p]: self.srp(_flatten_hwc(taps.pop(p))) for p in self.points}

    @torch.inference_mode()
    def srp_batch(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """The SRP rows of every tap of one (B, 3, H, W) float32 batch
        already on the device."""
        return self._project(self.model(x, capture=self.points)[1])

    @torch.inference_mode()
    def get_activations(self, loader: Iterable, store: str = "device", retain_ids=None):
        """All-tap SRP activations over a loader of (batch, keys).

        store="device": {name: (N, k) bfloat16 tensor on the device} —
        the 73k × 14 × 4096 NSD store is ≈ 8.4 GB, resident on an 80 GB
        card. store="host": {name: (N, k) float32 CPU tensor}.
        retain_ids: a set of stimulus ids (str) to keep. Every stimulus
        still goes through the all-tap forward and SRP (a batch with no
        kept row too); only the kept rows are written, in loader order,
        into a store of len(retain_ids) rows, at positions counted on the
        host: no per-batch synchronisation on the device store, and no
        concatenation on either.
        Returns (acts, ids) with row i of every tap belonging to ids[i].
        """
        if store not in ("device", "host"):
            raise ValueError(f"store must be 'device' or 'host', got {store!r}")
        n_total = len(loader.dataset)
        n_rows = n_total if retain_ids is None else len(retain_ids)
        dims = self.out_dims()
        dtype, on = (torch.bfloat16, self.device) if store == "device" else (torch.float32, "cpu")
        acts = {name: torch.empty((n_rows, k), dtype=dtype, device=on) for name, k in dims.items()}
        ids: list = []
        n_seen = 0
        batches = _batches(loader)
        while True:
            with span("extractor.batch"):
                item = next(batches, None)
                if item is None:
                    break
                x, keys = item
                n_seen += len(keys)
                kept = None  # every row of the batch
                if retain_ids is not None:
                    kept = [i for i, k in enumerate(keys) if str(k) in retain_ids]
                    if len(kept) == len(keys):
                        kept = None
                    else:
                        rows = torch.as_tensor(kept, dtype=torch.long)
                        if store == "device" and self.device.type == "cuda":
                            rows = rows.pin_memory().to(self.device, non_blocking=True)
                pos = len(ids)
                m = len(keys) if kept is None else len(kept)
                srp = self._srp_rows(x)
                with span("extractor.store"):
                    for name, out in srp.items():
                        if kept is not None:
                            out = (out.index_select(0, rows) if store == "device"
                                   else out.cpu()[rows])
                        acts[name][pos:pos + m] = out
                    del srp
                ids.extend(keys if kept is None else [keys[i] for i in kept])
        if n_seen != n_total:
            raise RuntimeError(f"loader yielded {n_seen} stimuli, expected {n_total}")
        if len(ids) < n_rows:
            acts = {name: a[:len(ids)] for name, a in acts.items()}
        if store == "device" and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        kept_msg = "" if retain_ids is None else f" kept of {n_total}"
        rprint(f"  SRP activations: {len(acts)} taps x {len(ids)} stimuli{kept_msg} ({store})",
               style="success")
        return acts, ids

    @torch.inference_mode()
    def extract_layers_exact(self, loader: Iterable, layer_names, stimulus_ids=None):
        """Full-resolution float32 taps of several layers in ONE pass.

        Returns ({layer: (N, D_layer) tensor on the device}, ids), rows
        in ``stimulus_ids`` order when given (ids absent from the loader
        are dropped with a warning). Where the kept rows are already the
        loader's first rows in order, each layer is a view of its store;
        otherwise the rows are gathered, one tap at a time (each store is
        released as its gathered copy is made).
        """
        point_of = {name: self._point_of(name) for name in layer_names}
        points = tuple(dict.fromkeys(point_of.values()))
        n_total = len(loader.dataset)
        store = {p: torch.empty((n_total, self.tap_dims[self.alias[p]]),
                                dtype=torch.float32, device=self.device)
                 for p in points}
        all_ids: list = []
        for x, keys in _batches(loader):
            taps = self._taps(x, points)
            for p in points:
                _write_hwc(store[p][len(all_ids):len(all_ids) + len(keys)], taps.pop(p))
            all_ids.extend(keys)
        if len(all_ids) != n_total:
            raise RuntimeError(f"loader yielded {len(all_ids)} stimuli, expected {n_total}")
        keep = None
        if stimulus_ids is not None:
            pos = {str(k): i for i, k in enumerate(all_ids)}
            keep = [pos[str(s)] for s in stimulus_ids if str(s) in pos]
            if len(keep) != len(stimulus_ids):
                rprint(f"Warning: {len(stimulus_ids) - len(keep)} of {len(stimulus_ids)} "
                       "requested stimulus_ids absent from the loader output "
                       f"(kept {len(keep)})", style="warning")
            all_ids = [all_ids[i] for i in keep]
        if keep is None or keep == list(range(len(keep))):
            acts = {name: store[p][:len(all_ids)] for name, p in point_of.items()}
        else:
            rows = torch.as_tensor(keep, device=self.device)
            for p in points:
                store[p] = store[p][rows]
            acts = {name: store[p] for name, p in point_of.items()}
        del store
        rprint(f"  Re-extracted {len(acts)} layers in one pass "
               f"({len(all_ids)} stimuli, exact, no SRP)", style="success")
        return acts, all_ids

    def extract_single_layer(self, loader: Iterable, layer_name: str, stimulus_ids=None):
        """Full-resolution float32 activations of ONE tap over a loader:
        ``extract_layers_exact`` for one layer, fetched to the host.
        Returns ((N, D) float32 numpy array, ids)."""
        acts, ids = self.extract_layers_exact(loader, [layer_name], stimulus_ids)
        return acts[layer_name].cpu().numpy(), ids

    @torch.inference_mode()
    def extract_single_layer_mean(self, loader: Iterable, layer_name: str, groups: dict,
                                  group_order: Sequence[str]):
        """Per-group means of one tap's full-resolution activations,
        accumulated on the device during the forward.

        Each batch's tap rows are added (``index_add_``) into a (G+1, D)
        float32 accumulator on the device; row G collects the stimuli of
        no group and is dropped. Counts are kept on the host; each mean is
        the sum over max(count, 1). groups: {group: [stimulus ids]};
        group_order: the output rows. Returns ((G, D) float32 tensor on
        the device, list(group_order))."""
        point = self._point_of(layer_name)
        seg_of = {str(sid): gi for gi, g in enumerate(group_order) for sid in groups[g]}
        n_groups = len(group_order)
        acc = torch.zeros((n_groups + 1, self.tap_dims[self.alias[point]]), dtype=torch.float32,
                          device=self.device)
        counts = np.zeros(n_groups, np.int64)
        for x, keys in _batches(loader):
            seg = np.asarray([seg_of.get(str(k), n_groups) for k in keys], np.int64)
            np.add.at(counts, seg[seg < n_groups], 1)
            rows = _flatten_hwc(self._taps(x, (point,))[point])
            acc.index_add_(0, torch.as_tensor(seg, device=self.device), rows)
        if (counts == 0).any():
            rprint(f"Warning: {int((counts == 0).sum())} of {n_groups} groups matched no "
                   "stimuli in the loader output (zero rows)", style="warning")
        denom = torch.as_tensor(np.maximum(counts, 1), dtype=torch.float32, device=self.device)
        means = acc[:n_groups] / denom[:, None]
        rprint(f"  Re-extracted {layer_name}: {n_groups} group means of dim {acc.shape[1]} "
               "(exact, no SRP, device-averaged)", style="success")
        return means, list(group_order)

    def free_projection_cache(self) -> None:
        """Drop the SRP matrices (~3.7 GB bf16 at AlexNet scale); they
        regenerate from the seed on the next use."""
        self.srp._cache.clear()


def configure_feature_extractor(cfg, model: nn.Module,
                                device: str | torch.device | None = None,
                                verbose: bool = False) -> FeatureExtractor:
    """Build a FeatureExtractor from an eval config."""
    return_nodes = list(cfg.get("return_nodes") or [])
    if not return_nodes:
        raise ValueError("return_nodes must be specified in config")
    extractor = FeatureExtractor(
        model, return_nodes,
        extract_pre_and_post=cfg.get("extract_pre_and_post", True),
        srp_k=cfg.get("srp_k", 4096),
        srp_seed=cfg.get("srp_seed", 0),
        image_size=cfg.get("image_size", 224),
        device=device,
    )
    suffix = f" ({len(return_nodes)} layers x pre/post)" if cfg.get("extract_pre_and_post", True) else ""
    rprint(f"  {len(extractor.points)} extraction points{suffix}", style="success")
    if verbose:
        rprint(f"    Points: {extractor.points}", style="info")
    return extractor
