"""The port's spans (``visreps_tpu_torch/core/profiling.py``) on a tiny
CPU NSD RSA eval: with recording off nothing is recorded and no CUDA
event or profiler annotation is made; with recording on the records nest
under one eval id, self times add up to the eval, and the SRP draws count
their matrices' bytes, still with no annotation where no profiler runs;
under ``trace`` the spans are ``user_annotation`` events that name an
idle gap inside them; ``PhaseTimer`` sums an eval's
spans; and the span primitives on their own."""
import copy
import json
from pathlib import Path

import pytest
import torch

import visreps_tpu_torch.core.db as tdb
import visreps_tpu_torch.evals as tevals
from visreps_tpu_torch.benchmarks import fixture as tfixture
from visreps_tpu_torch.core import profiling
from visreps_tpu_torch.core.config import load_config
from visreps_tpu_torch.ops.srp import SRPTransform
from visreps_tpu_torch.run import validate_config

REPO = Path(__file__).resolve().parents[1]
SRP_K = 32
N_STIMULI = 12 + 2 * 20
OVERRIDES = [
    "mode=eval", "neural_dataset=nsd", "subject_idx=[0,1]",
    "region=[early visual stream,ventral visual stream]", "analysis=rsa",
    "compare_method=spearman", "bootstrap=true", "n_bootstrap=8", "n_select=10",
    "batchsize=16", "num_workers=2", "load_model_from=torchvision", "model_name=AlexNet",
    "pretrained_dataset=none", "extract_pre_and_post=true", f"srp_k={SRP_K}",
    "uint8_transfer=true", "log_expdata=true", "seed=1",
]
PHASE_KEYS = {"model_load_s", "data_load_s", "extraction_s", "extraction_loader_s",
              "phase1_selection_s", "phase2_extract_s", "scoring_bootstrap_s"}
PHASE_SPANS = ("model_load", "data_load", "extraction", "rsa.selection", "rsa.exact",
               "rsa.scoring")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (a parallel test run otherwise
    oversubscribes the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run_eval(tmp_path_factory):
    """``run_eval()`` runs the tiny NSD RSA eval on the CPU and returns the
    extractor it built."""
    tmp = tmp_path_factory.mktemp("spans")
    meta = tfixture.ensure_fixture(tmp / "fx", n_shared=12, n_unique=20, n_subjects=2,
                                   n_regions=2, n_voxels=8, img_size=64)
    cfg = validate_config(load_config(str(REPO / "configs/eval/base.json"), OVERRIDES))
    mp = pytest.MonkeyPatch()
    mp.setenv("NSD_DATA_DIR", str(Path(meta["pickle"]).parent))
    mp.setenv("NSD_STIMULI_HDF5", meta["stimuli"])
    mp.setattr(tdb, "RESULTS_DB_PATH", tmp / "results.db")
    made = []
    configure = tevals.configure_feature_extractor

    def keep(*args, **kwargs):
        made.append(configure(*args, **kwargs))
        return made[-1]

    mp.setattr(tevals, "configure_feature_extractor", keep)

    def run():
        tevals.eval(copy.deepcopy(cfg), device="cpu")
        return made[-1]

    yield run
    mp.undo()


def _refuse(*args, **kwargs):
    raise AssertionError("called with recording off and no profiler")


def test_recording_off_records_nothing(run_eval, monkeypatch):
    """The default: no record, no CUDA event, no ``record_function``; the
    eval's spans fill its totals and ``LAST_PHASE_TIMES`` keeps its keys."""
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    run_eval()
    assert profiling.take_spans() == [] and len(profiling._REC.records) == 0
    assert set(tevals.LAST_PHASE_TIMES) == PHASE_KEYS
    phases = profiling.totals().phases
    assert phases["extraction"][1] == N_STIMULI
    for name, key in zip(PHASE_SPANS, ("model_load_s", "data_load_s", "extraction_s",
                                       "phase1_selection_s", "phase2_extract_s",
                                       "scoring_bootstrap_s")):
        assert phases[name][0] == pytest.approx(tevals.LAST_PHASE_TIMES[key], rel=1e-12)
    assert tevals.LAST_PHASE_TIMES["extraction_loader_s"] <= phases["loader_wait"][0]


@pytest.fixture(scope="module")
def recorded(run_eval):
    """The records of one eval; ``record_function`` refuses to be called,
    since spans annotate only under a profiler."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", _refuse)
        mp.setattr(torch.autograd.profiler, "record_function", _refuse)
        with profiling.recording():
            extractor = run_eval()
            records = profiling.take_spans()
    return records, extractor


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r["name"], []).append(r)
    return out


def test_recorded_spans_nest_under_one_eval(recorded):
    records, _ = recorded
    by_id = {r["id"]: r for r in records}
    named = _by_name(records)
    (root,) = named["eval"]
    assert root["parent"] is None and root["eval"] is not None
    assert all(r["eval"] == root["eval"] for r in records)
    for r in records:
        assert r["start_ns"] <= r["end_ns"] and r["device_s"] >= 0
        if r is not root:
            parent = by_id[r["parent"]]
            assert parent["start_ns"] <= r["start_ns"] and r["end_ns"] <= parent["end_ns"]

    def parents(name):
        return {by_id[r["parent"]]["name"] for r in named[name]}

    assert {n: by_id[named[n][0]["parent"]]["name"] for n in PHASE_SPANS} == \
        dict.fromkeys(PHASE_SPANS, "eval")
    for child in ("zoo.init", "zoo.to_device", "extractor.probe"):
        assert parents(child) == {"model_load"}
    assert parents("extractor.batch") == {"extraction"}
    for child in ("extractor.srp_product", "extractor.store"):
        assert parents(child) == {"extractor.batch"}
    assert parents("srp.draw") == {"extractor.srp_product"}
    for child in ("loader_wait", "extractor.h2d", "extractor.forward"):  # phase 2's too
        assert parents(child) == {"extractor.batch", "rsa.exact"}
    assert named["extraction"][0]["items"] == N_STIMULI
    assert all(r["counts"] == {} for n, rs in named.items() if n != "srp.draw" for r in rs)


def test_self_times_add_up_to_the_eval(recorded):
    """Self time = a span's seconds less its children's: never negative,
    and over every span of the eval it adds up to the root's."""
    records, _ = recorded
    children = {}
    for r in records:
        children.setdefault(r["parent"], []).append(r)

    def self_s(r, key):
        return key(r) - sum(key(c) for c in children.get(r["id"], []))

    for key in (lambda r: r["device_s"], lambda r: (r["end_ns"] - r["start_ns"]) / 1e9):
        selfs = [self_s(r, key) for r in records]
        assert min(selfs) >= -1e-9
        (root,) = [r for r in records if r["name"] == "eval"]
        assert sum(selfs) == pytest.approx(key(root), rel=1e-9)


def test_srp_draw_counts_its_matrices(recorded):
    """``srp.draw``'s bytes = 2·D·min(D, k) over the distinct
    tap widths, one draw each."""
    records, extractor = recorded
    draws = _by_name(records)["srp.draw"]
    widths = set(extractor.tap_dims.values())
    assert len(draws) == len(widths)
    assert sum(r["counts"]["bytes"] for r in draws) == \
        sum(2 * d * min(d, SRP_K) for d in widths)
    srp = SRPTransform(k=16, seed=3, device="cpu")  # a width under k draws D × D
    with profiling.recording():
        for d in (8, 40, 8):
            srp.matrix_chunks(d)
        assert [r["counts"]["bytes"] for r in profiling.take_spans()] == [2 * 8 * 8, 2 * 40 * 16]


def test_trace_shows_spans_and_names_a_gap(run_eval, tmp_path):
    """Under ``trace`` the spans are ``user_annotation`` events (the root
    ``eval`` is not one); a device idle gap planted inside the extraction
    span is named by it, by ``summarize_trace``'s rule."""
    with profiling.trace(tmp_path) as path:
        run_eval()
    assert profiling.take_spans() == []  # a trace annotates, and records nothing
    data = json.loads(path.read_text())
    events = data["traceEvents"]
    notes = [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    names = {e["name"] for e in notes}
    assert {*PHASE_SPANS, "zoo.init", "extractor.batch", "extractor.forward",
            "extractor.srp_product", "srp.draw", "extractor.store",
            "loader_wait"} <= names and "eval" not in names
    timed = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
    start = min(float(e["ts"]) for e in timed)
    end = max(float(e["ts"]) + float(e["dur"]) for e in timed)
    (ext,) = [e for e in notes if e["name"] == "extraction"]
    a, b = float(ext["ts"]) + 1.0, float(ext["ts"]) + float(ext["dur"]) - 1.0
    events += [{"ph": "X", "cat": "kernel", "name": "k", "ts": start, "dur": a - start},
               {"ph": "X", "cat": "kernel", "name": "k", "ts": b, "dur": end - b}]
    path.write_text(json.dumps(data))
    gap = profiling.summarize_trace(path)["gaps"][0]
    assert gap["ms"] == pytest.approx((b - a) / 1e3)
    assert gap["host_op"]["name"] == "extraction"


def test_span_primitives():
    """Nesting, counts set inside a block, totals per eval, an exception
    inside a span, nested ``recording`` and the record bound."""
    with profiling.eval_span():
        with profiling.span("outer", items=3, a=1) as outer:
            with profiling.span("inner") as inner:
                outer.counts["b"] = 2
        assert outer.seconds >= inner.seconds >= 0
        totals = profiling.totals()
        assert totals.phases["outer"][1] == 3 and totals.seconds("inner") == inner.seconds
        assert profiling.take_spans() == []
    with profiling.recording():
        with profiling.recording():
            with profiling.eval_span() as root:
                with pytest.raises(ValueError):
                    with profiling.span("failing", n=1):
                        raise ValueError
                with profiling.span("open"):
                    taken = profiling.take_spans()  # the open ones stay
        rest = profiling.take_spans()
    assert [r["name"] for r in taken] == ["failing"]
    assert [r["name"] for r in rest] == ["eval", "open"]
    assert rest[1]["parent"] == rest[0]["id"] and taken[0]["parent"] == rest[0]["id"]
    assert taken[0]["eval"] == rest[0]["eval"] and taken[0]["counts"] == {"n": 1}
    assert root.seconds == pytest.approx(rest[0]["device_s"])
    with profiling.recording():
        for _ in range(profiling.MAX_RECORDS + 5):
            with profiling.span("x"):
                pass
        assert len(profiling.take_spans()) == profiling.MAX_RECORDS
