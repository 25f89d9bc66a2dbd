"""Phase-1 retention and the SRP store rule of the PyTorch port against
the JAX package's, on the CPU.

1. The retain set and the store each eval hands ``get_activations``,
   read from both packages' own eval code (stub extractors record the
   call and stop the eval), over backend × analysis × ``acts_retain`` ×
   the store estimate. The card is faked: ``jax.default_backend`` returns
   "gpu" on the JAX side, the port's eval gets a ``cuda`` device.
2. ``get_activations(retain_ids=...)`` keeps the full store's rows at
   those ids in loader order, on both stores, and forwards every batch.
3. A tiny NSD eval with ``acts_retain=true`` equals the same eval
   without retention bit for bit, and the JAX package's retained eval at
   the e2e parity's tolerance; the store is freed before phase 2.
"""
import weakref

import numpy as np
import pytest
import torch

import jax

import visreps_tpu.evals as jevals
from visreps_tpu.core.config import Config as JaxConfig

import visreps_tpu_torch.core.db as tdb
import visreps_tpu_torch.evals as tevals
from visreps_tpu_torch.core.config import Config
from visreps_tpu_torch.models import extractor as textractor
from visreps_tpu_torch.models.extractor import FeatureExtractor
from visreps_tpu_torch.models.standard import AlexNet

from test_torch_port_e2e import _cfg, _top_two_gap, nsd_world  # noqa: F401  (a fixture)

# ── 1. the decision grid ──
N_SHARED, N_TRAIN, N_SELECT = 20, 20, 10  # 2 subjects: 60 stimuli, a 20-id plan union
N_STIMULI = N_SHARED + 2 * N_TRAIN
# Σ out_dims: the whole store under the budget; the whole store over it but
# the plan's rows under it; the plan's rows over it too.
ESTIMATES = {"low": 10**6, "mid": 15 * 10**7, "high": 10**9}
assert 2 * N_STIMULI * ESTIMATES["low"] < 9e9
assert 2 * 2 * N_SELECT * ESTIMATES["mid"] < 9e9 <= 2 * N_STIMULI * ESTIMATES["mid"]
assert 9e9 <= 2 * 2 * N_SELECT * ESTIMATES["high"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (a parallel test run otherwise
    oversubscribes the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Extracted(Exception):
    """Raised by the stub extractor once it has recorded its call."""


class _StubExtractor:
    """Reports Σ out_dims ``total`` over two taps; records the store and
    retain set it is handed and stops the eval."""

    def __init__(self, total: int, seen: dict):
        self.total, self.seen = total, seen
        self.tap_dims = {"a": 10, "b": 10}
        self.device = torch.device("cpu")

    def out_dims(self):
        return {"a": self.total // 2, "b": self.total - self.total // 2}

    def get_activations(self, loader, store="host", retain_ids=None, **kwargs):
        self.seen.update(store=store, retain=None if retain_ids is None else set(retain_ids))
        raise _Extracted


class _Things:
    dataset = range(N_STIMULI)


def _all_data() -> dict:
    """In-memory NSD data: 20 shared test stimuli and 20 train stimuli of
    each of 2 subjects, 2 regions."""
    img = np.zeros((8, 8, 3), np.uint8)
    shared = [f"{i:03d}" for i in range(N_SHARED)]
    neural = {}
    for r in ("early visual stream", "ventral visual stream"):
        neural[r] = {s: {"train": {f"{N_SHARED + s * N_TRAIN + i:03d}": np.zeros(4, np.float32)
                                   for i in range(N_TRAIN)},
                         "test": {k: np.zeros(4, np.float32) for k in shared}}
                     for s in (0, 1)}
    return {"stimuli": {f"{i:03d}": img for i in range(N_STIMULI)}, "neural": neural,
            "shared_test_ids": shared}


def _grid_cfg(cls, analysis: str, acts_retain):
    cfg = _cfg(cls).merge({"n_select": N_SELECT, "acts_retain": acts_retain})
    if analysis == "things":
        cfg = cfg.merge({"neural_dataset": "things-behavior", "subject_idx": "N/A",
                         "region": "N/A"})
    elif analysis == "encoding":
        cfg = cfg.merge({"analysis": "encoding_score", "compare_method": "pearson"})
    return cfg


@pytest.mark.parametrize("estimate", list(ESTIMATES))
@pytest.mark.parametrize("acts_retain", ["auto", True, False])
@pytest.mark.parametrize("analysis", ["rsa", "encoding", "things"])
@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_retain_and_store_decision_match_jax(backend, analysis, acts_retain, estimate,
                                             monkeypatch):
    total = ESTIMATES[estimate]
    data = _all_data()
    jax_seen, torch_seen = {}, {}
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu" if backend == "cuda" else "cpu")
    for mod, seen in ((jevals, jax_seen), (tevals, torch_seen)):
        monkeypatch.setattr(mod, "load_model", lambda *a, **k: None)
        monkeypatch.setattr(mod, "configure_feature_extractor",
                            lambda *a, seen=seen, **k: _StubExtractor(total, seen))
        monkeypatch.setattr(mod, "load_all_nsd_data", lambda *a, **k: data)
        monkeypatch.setattr(mod, "get_neural_loader", lambda cfg: (None, _Things()))
    monkeypatch.setattr(tevals, "resolve_device", lambda device=None: torch.device(backend))
    with pytest.raises(_Extracted):
        jevals.eval(_grid_cfg(JaxConfig, analysis, acts_retain))
    with pytest.raises(_Extracted):
        tevals.eval(_grid_cfg(Config, analysis, acts_retain))
    assert torch_seen == jax_seen
    assert jax_seen["store"] in ("host", "device")
    if backend == "cpu":
        assert jax_seen["store"] == "host"


@pytest.mark.parametrize("n_stimuli,acts_retain,expect", [
    (20, True, (None, "device")),     # the plan holds every stimulus: no retention
    (21, True, (20, "device")),
    (21, False, (None, "device")),
    (0, "auto", (None, "host")),      # nothing to store
])
def test_store_plan_edges(n_stimuli, acts_retain, expect):
    union = {str(i) for i in range(20)}
    retain, store = tevals.store_plan(Config({"acts_retain": acts_retain}), "cuda",
                                      n_stimuli, 4096, union)
    assert (None if retain is None else len(retain), store) == expect


def test_acts_store_override_wins():
    for store in ("host", "device"):
        for device_type in ("cpu", "cuda"):
            assert tevals.store_plan(Config({"acts_store": store}), device_type, 100,
                                     10**9)[1] == store


# ── 2. get_activations(retain_ids=...) ──
class _Loader:
    """(uint8 batch, keys) in order, 4 at a time, over 14 seeded images."""

    def __init__(self, n: int = 14, batch: int = 4):
        self.images = np.random.RandomState(3).randint(0, 256, (n, 64, 64, 3)).astype(np.uint8)
        self.keys = [f"s{i:02d}" for i in range(n)]
        self.dataset = self.keys
        self.batch = batch

    def __iter__(self):
        for i in range(0, len(self.keys), self.batch):
            yield self.images[i:i + self.batch], self.keys[i:i + self.batch]


@pytest.fixture(scope="module")
def extractor():
    torch.manual_seed(0)
    return FeatureExtractor(AlexNet(), ["conv1", "conv5", "fc1"], srp_k=16, image_size=64,
                            device="cpu")


@pytest.mark.parametrize("store", ["host", "device"])
def test_get_activations_keeps_the_retained_rows(extractor, store, monkeypatch):
    loader = _Loader()
    full, ids = extractor.get_activations(loader, store=store)
    # batches: s00-s03 partly kept, s04-s07 none, s08-s11 all, s12-s13 partly
    keep = {"s01", "s03", "s08", "s09", "s10", "s11", "s13"}
    forwards = []
    taps = FeatureExtractor._taps

    def counting_taps(self, x, points):
        forwards.append(len(x))
        return taps(self, x, points)

    monkeypatch.setattr(FeatureExtractor, "_taps", counting_taps)
    got, got_ids = extractor.get_activations(loader, store=store, retain_ids=keep)
    assert forwards == [4, 4, 4, 2]
    assert got_ids == [k for k in ids if k in keep]
    rows = [ids.index(k) for k in got_ids]
    assert list(got) == list(full) and len(got) == 6
    for name, a in got.items():
        assert a.dtype == (torch.bfloat16 if store == "device" else torch.float32)
        assert a.shape == (len(keep), 16)
        assert torch.equal(a, full[name][rows]), name


def test_get_activations_retain_keeps_nothing_absent(extractor):
    got, got_ids = extractor.get_activations(_Loader(), store="host",
                                             retain_ids={"s02", "not-a-stimulus"})
    assert got_ids == ["s02"]
    assert all(a.shape == (1, 16) for a in got.values())


# ── 3. the retained eval ──
@pytest.fixture(scope="module")
def own_store_evals(nsd_world):
    """The port's eval on its own SRP store (the world's JAX weights) with
    ``acts_retain`` true and false, each into its own results.db; with a
    weakref to each extracted tap tensor read when phase 2 begins."""
    tmp = nsd_world["tmp"]
    own_get, own_exact = FeatureExtractor.get_activations, FeatureExtractor.extract_layers_exact
    seen = {}

    def get_activations(self, loader, store="device", retain_ids=None):
        acts, ids = own_get(self, loader, store=store, retain_ids=retain_ids)
        seen["refs"] = [weakref.ref(a) for a in acts.values()]
        seen["rows"] = len(ids)
        return acts, ids

    def extract_layers_exact(self, *args, **kwargs):
        seen["alive_at_phase2"] = sum(r() is not None for r in seen["refs"])
        return own_exact(self, *args, **kwargs)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tevals, "configure_feature_extractor", textractor.configure_feature_extractor)
        mp.setattr(FeatureExtractor, "get_activations", get_activations)
        mp.setattr(FeatureExtractor, "extract_layers_exact", extract_layers_exact)
        for retain in (True, False):
            mp.setattr(tdb, "RESULTS_DB_PATH", tmp / f"torch_own_retain_{retain}.db")
            results = tevals.eval(_cfg(Config).merge({"acts_retain": retain}), device="cpu")
            out[retain] = (results, dict(seen))
        # phase 2 one layer a pass, as on a card whose free memory holds one
        mp.setattr(tevals, "_exact_groups", lambda ext, layers, n: [[l] for l in layers])
        mp.setattr(tdb, "RESULTS_DB_PATH", tmp / "torch_own_passes.db")
        out["passes"] = (tevals.eval(_cfg(Config), device="cpu"), dict(seen))
    return out


def test_retained_eval_equals_unretained_bit_for_bit(own_store_evals):
    (kept, kept_seen), (full, full_seen) = own_store_evals[True], own_store_evals[False]
    assert kept_seen["rows"] == 20 and full_seen["rows"] == 52  # 2 subjects × n_select 10
    assert len(kept) == len(full) == 4
    for k, f in zip(kept, full):
        assert k == f


def test_store_is_freed_before_phase_two(own_store_evals):
    for _, seen in own_store_evals.values():
        assert len(seen["refs"]) == 14
        assert seen["alive_at_phase2"] == 0


def test_retained_eval_matches_jax_retained(nsd_world):
    """Both packages retain (``acts_retain=true``); the port selects on
    the JAX eval's retained store, as in the e2e parity."""
    jax_results, torch_results = nsd_world["run"]({"acts_retain": True}, "retain")
    jacts, jids = nsd_world["stores"]["jax"]
    assert len(jids) == 20 and all(a.shape[0] == 20 for a in jacts.values())
    assert len(torch_results) == len(jax_results) == 4
    for j, t in zip(jax_results, torch_results):
        js = {e["layer"]: e["score"] for e in j["layer_selection_scores"]}
        ts = {e["layer"]: e["score"] for e in t["layer_selection_scores"]}
        assert list(ts) == list(js) and len(ts) == 14
        np.testing.assert_allclose([ts[l] for l in js], list(js.values()), atol=1e-4)
        if t["layer"] != j["layer"]:
            assert _top_two_gap(j) <= 1e-4
            continue
        assert t["score"] == pytest.approx(j["score"], abs=1e-4)
        np.testing.assert_allclose(t["bootstrap_scores"], j["bootstrap_scores"], atol=1e-4)
        assert t["ci_low"] == pytest.approx(j["ci_low"], abs=1e-4)
        assert t["ci_high"] == pytest.approx(j["ci_high"], abs=1e-4)


def test_phase_two_in_passes_equals_one_pass(own_store_evals):
    (passes, _), (one, _) = own_store_evals["passes"], own_store_evals[False]
    assert len({r["layer"] for r in one}) > 1
    assert passes == one


def test_exact_groups_fit_half_the_free_memory(monkeypatch):
    class Ext:
        device = torch.device("cuda")
        tap_dims = {"a": 5, "b": 5, "c": 3, "d": 10, "e": 1, "f": 30}

    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (90, 100))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev: 30)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev: 20)
    # free 90 + 10 cached: groups of at most 50 bytes of f32 rows; a layer
    # over that alone goes alone
    assert tevals._exact_groups(Ext(), list("abcdef"), 1) == [["a", "b"], ["c"], ["d", "e"], ["f"]]
    Ext.device = torch.device("cpu")
    assert tevals._exact_groups(Ext(), list("abcdef"), 1000) == [list("abcdef")]
