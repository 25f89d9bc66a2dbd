"""The RSA eval with Spearman scores: its eval keys, its plain reference
and the comparison that decides ``correct``.

The reference works out from the cell's inputs, by the eval's protocol
(``visreps_tpu_torch/evals.py``, the reference's two-phase RSA):

  * the selection plan: per subject, its train stimuli in the loader's
    key order sorted as strings, ``RandomState(42).choice`` of
    ``n_select`` of them when there are more;
  * phase 1: every tap's SRP rows of the plan (the forward in f32 with
    TF32 off, each tap flattened in (H, W, C) order, rounded to bf16,
    projected with f32 accumulation, kept in the type the eval's store
    rule picks: bf16 on the card), their RDMs and the neural RDMs in f64,
    and per (region, subject) and tap the Spearman score by ordinal ranks
    and Σd²;
  * phase 2 and scoring: the full-resolution taps of a layer on the
    shared test stimuli (in id order), its RDM and each pair's neural RDM
    in f64, the average-tie Spearman point score and, over the
    ``RandomState(42)`` index sets of 90 % of the test stimuli, each
    subset's average-tie Spearman.

Three numbers are compared, each the largest over the window's evals
and pairs, each against the cell's limit (``limits/<cell>.json``):

  * ``selection_gap``: per (region, subject), the largest gap between a
    tap's selection score and the reference's, or, where larger, how far
    the reference's score of the chosen layer lies below the reference's
    best (a wrong choice);
  * ``point_gap``: the gap between a pair's point score and the
    reference's score of the same layer;
  * ``bootstrap_gap``: the largest gap between a pair's bootstrap scores
    and the reference's over the same index sets, or between the CIs.

A result that is missing, has another layer set or another number of
bootstrap scores, or holds a NaN reads as infinite.

An analysis file gives ``NUMBERS`` (the limits' keys),
``overrides(cell)`` (the eval's analysis keys), ``check(cell, seed,
device, sides)`` (the reference once, each side's eval outputs against
it), ``control(cell, seed, device)`` (the control's eval output) and
``device_work_s(cell, ev)`` (the least time of the analysis's own work
in one eval record, for ``mfu``; None where nothing was recorded).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench import yardstick
from portbench.reference import (Forward, average_ranks, bootstrap_index_sets, ordinal_ranks,
                                 pearson, rdm_triangle, store_dtype)
from portbench.srp_rule import out_dim

NUMBERS = ("selection_gap", "point_gap", "bootstrap_gap")


def overrides(cell: dict) -> dict:
    if cell["compare_method"] != "spearman":
        raise ValueError(f"{__name__} scores by Spearman, the mix asks for "
                         f"{cell['compare_method']!r}")
    return {"analysis": "rsa", "compare_method": "spearman", "n_select": cell["n_select"],
            "bootstrap": cell["bootstrap"], "n_bootstrap": cell["n_bootstrap"]}


class Reference:
    """The reference of one run: cell ``cell`` (its configuration and
    traffic mix merged), seed ``seed``."""

    def __init__(self, cell: dict, seed: int, device, tf32: bool = False):
        self.cell = cell
        self.fwd = Forward(cell, seed, device, tf32)
        self.data = self.fwd.data
        self.device = self.fwd.device
        self.pairs = self.data.pairs
        self.taps = self.fwd.taps

    def plan(self) -> dict:
        """{subject: selection stimulus ids} (the same for every region)."""
        out = {}
        n_select = self.cell["n_select"]
        for s in self.data.subjects:
            train = self.data.train[(self.data.regions[0], s)]
            matched = [k for k in self.data.order if k in train]
            if n_select is not None and n_select < len(matched):
                sel = np.random.RandomState(42).choice(len(matched), size=n_select,
                                                       replace=False)
            else:
                sel = np.arange(len(matched))
            out[s] = [matched[i] for i in sel]
        return out

    # ── phase 1 ──
    def selection_scores(self) -> dict:
        """{(region, subject): {tap: score}} by ordinal-rank Spearman (Σd²)."""
        plan = self.plan()
        widths = self.fwd.widths(self.taps, self.data.order)
        matrices = self.fwd.srp_matrices(widths)
        k = int(self.cell["srp_k"])
        dtype = store_dtype(self.device, len(self.data.order),
                            sum(out_dim(w, k) for w in widths.values()),
                            len(set().union(*plan.values())))
        out = {}
        for s in self.data.subjects:
            ids = plan[s]
            store = self.fwd.srp_store(ids, widths, matrices, dtype)
            model_ranks = {t: ordinal_ranks(rdm_triangle(store.pop(t))) for t in self.taps}
            m = float(len(ids) * (len(ids) - 1) // 2)
            for r in self.data.regions:
                y = torch.as_tensor(np.stack([self.data.train[(r, s)][i] for i in ids]),
                                    device=self.device)
                ry = ordinal_ranks(rdm_triangle(y))
                out[(r, s)] = {t: float(1.0 - 6.0 * ((model_ranks[t] - ry) ** 2).sum()
                                        / (m * (m * m - 1.0))) for t in self.taps}
        del matrices
        return out

    # ── phase 2 and scoring ──
    def scores(self, pair_layers: dict) -> dict:
        """{(pair, layer): (point score, (B,) bootstrap scores)} for each
        pair and each layer in ``pair_layers[pair]``."""
        needed = sorted({l for ls in pair_layers.values() for l in ls})
        test_ids = self.data.test_ids
        model = self.fwd.exact(test_ids, needed)
        n = len(test_ids)
        idx = torch.as_tensor(bootstrap_index_sets(n, int(self.cell["n_bootstrap"])),
                              device=self.device)
        iu = torch.triu_indices(n, n, offset=1, device=self.device)
        neural = {}
        for pair in pair_layers:
            y = torch.as_tensor(np.stack([self.data.test[pair][i] for i in test_ids]),
                                device=self.device)
            neural[pair] = rdm_triangle(y)
        out = {}
        for pair, layers in pair_layers.items():
            ry = average_ranks(neural[pair])
            for layer in layers:
                out[(pair, layer)] = [float(pearson(average_ranks(model[layer]), ry)), []]
        chunk = int(self.cell["reference_boot_chunk"])
        m_sub = idx.shape[1] * (idx.shape[1] - 1) // 2
        for start in range(0, idx.shape[0], chunk):
            ix = idx[start:start + chunk]
            inc = torch.zeros((ix.shape[0], n), dtype=torch.bool, device=self.device)
            inc.scatter_(1, ix, True)
            sel = inc[:, iu[0]] & inc[:, iu[1]]

            def sub_ranks(tri):
                return average_ranks(tri[None].expand_as(sel)[sel].view(-1, m_sub))

            model_r = {l: sub_ranks(model[l]) for l in needed}
            for pair, layers in pair_layers.items():
                ry = sub_ranks(neural[pair])
                for layer in layers:
                    out[(pair, layer)][1].append(pearson(model_r[layer], ry).cpu())
        return {key: (point, torch.cat(boot).numpy()) for key, (point, boot) in out.items()}

    def results(self) -> tuple[dict, list[dict]]:
        """(selection scores, the eval's results as the program reports
        them, chosen by this reference itself): the control's output."""
        sel = self.selection_scores()
        best = {p: max(sc, key=lambda l: sc[l] if sc[l] == sc[l] else -np.inf)
                for p, sc in sel.items()}
        scored = self.scores({p: {best[p]} for p in self.pairs})
        results = []
        for p in self.pairs:
            point, boot = scored[(p, best[p])]
            results.append({
                "layer": best[p], "score": point,
                "ci_low": float(np.percentile(boot, 2.5)),
                "ci_high": float(np.percentile(boot, 97.5)),
                "bootstrap_scores": boot.tolist(),
                "layer_selection_scores": [{"layer": l, "score": v} for l, v in sel[p].items()],
            })
        return sel, results


# ── the comparison ──
def _gap(a, b) -> float:
    g = abs(float(a) - float(b))
    return g if math.isfinite(g) else math.inf


def pair_gaps(res: dict, ref_sel: dict, ref_scores: dict, pair) -> dict:
    """The three numbers of one result ``res`` of pair ``pair``."""
    sel = {d["layer"]: d["score"] for d in res.get("layer_selection_scores", [])}
    ref = ref_sel[pair]
    layer = res.get("layer")
    out = dict.fromkeys(NUMBERS, math.inf)
    if set(sel) != set(ref) or layer not in ref:
        return out
    best = max(v for v in ref.values() if v == v)
    out["selection_gap"] = max(max(_gap(sel[l], ref[l]) for l in ref),
                               _gap(best, ref[layer]))
    if (pair, layer) not in ref_scores:
        return out
    point, boot = ref_scores[(pair, layer)]
    out["point_gap"] = _gap(res.get("score"), point)
    prog = np.asarray(res.get("bootstrap_scores") or [], np.float64)
    if prog.shape == boot.shape and prog.size:
        gaps = [float(np.max(np.abs(prog - boot))),
                _gap(res.get("ci_low"), np.percentile(boot, 2.5)),
                _gap(res.get("ci_high"), np.percentile(boot, 97.5))]
        out["bootstrap_gap"] = max(g if math.isfinite(g) else math.inf for g in gaps)
    return out


def compare(runs: list, pairs: list, ref_sel: dict, ref_scores: dict, limits: dict) -> dict:
    """``runs``: each eval's result list, one result per pair in ``pairs``'
    order. Returns {"readings": {number: largest value}, "attempted",
    "failed", "correct"}."""
    readings = dict.fromkeys(NUMBERS, 0.0)
    attempted = failed = 0
    for results in runs:
        for i, pair in enumerate(pairs):
            attempted += 1
            gaps = (pair_gaps(results[i], ref_sel, ref_scores, pair) if i < len(results)
                    else dict.fromkeys(NUMBERS, math.inf))
            for k, v in gaps.items():
                readings[k] = max(readings[k], v)
            failed += any(gaps[k] > limits[k] for k in NUMBERS)
        if len(results) != len(pairs):
            failed += 1
    return {"readings": readings, "attempted": attempted, "failed": failed,
            "correct": attempted > 0 and failed == 0}


def layers_to_score(runs: list, pairs: list, ref_sel: dict) -> dict:
    """{pair: layers whose test scores the reference must work out}: every
    layer an eval chose for the pair."""
    return {pair: {r[i].get("layer") for r in runs if i < len(r)} & set(ref_sel[pair])
            for i, pair in enumerate(pairs)}


@torch.inference_mode()
def check(cell: dict, seed: int, device, sides: dict) -> dict:
    """{side: comparison} of each side's eval outputs ``sides[side]`` (a
    list of evals) against one reference of this seed, and under
    ``"notes"`` the reference's chosen layers and narrowest selection
    margin."""
    ref = Reference(cell, seed, device)
    ref_sel = ref.selection_scores()
    every = [r for runs in sides.values() for r in runs]
    ref_scores = ref.scores(layers_to_score(every, ref.pairs, ref_sel))
    out = {side: compare(runs, ref.pairs, ref_sel, ref_scores, cell["limits"])
           for side, runs in sides.items()}
    out["notes"] = {
        "reference_layers": [max(v, key=v.get) for v in ref_sel.values()],
        "selection_margin": min(sorted(v.values())[-1] - sorted(v.values())[-2]
                                for v in ref_sel.values())}
    return out


@torch.inference_mode()
def control(cell: dict, seed: int, device) -> list:
    """The control's eval output: the reference with TF32 on in the
    forward, the nearest precision below the configuration's float32."""
    return Reference(cell, seed, device, tf32=True).results()[1]


def device_work_s(cell: dict, ev: dict) -> float | None:
    """Least seconds of the eval's RDMs, each at the (n, d, type) handed to
    the kernel's wrapper (``probes/rdm_shapes.py``), by
    ``yardstick.rdm_bound_s``."""
    shapes = ev.get("rdm_shapes")
    if not shapes:
        return None
    return sum(yardstick.rdm_bound_s(n, d, t) for n, d, t in shapes)
