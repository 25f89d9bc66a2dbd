"""The span probe (``probes/spans.py``) and its five readers: a traced run
of a tiny CPU cell reads them all, a program without spans leaves them
out, and the shared arithmetic on hand-made records."""
from __future__ import annotations

import io
import json
import shutil
from pathlib import Path

import pytest
import torch

from portbench import cells, harness

ROOT = Path(__file__).resolve().parents[2]
SECONDS = ("model_init_s", "forward_s", "srp_product_s", "srp_draw_s")
READERS = (*SECONDS, "srp_drawn_gb")
K = 32


@pytest.fixture
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _tiny_cell(tmp_path: Path) -> dict:
    """``test_portbench_spec.test_new_cell_needs_only_new_files``' tiny
    cell (AlexNet, k = 32, 52 stimuli), added as files and entries to a
    copy of the tree, with the span readers listing it."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_data", "_cache", "__pycache__"))
    bench = tmp_path / "portbench"
    config = json.loads((bench / "configs" / "alexnet.json").read_text())
    (bench / "configs" / "tiny.json").write_text(json.dumps(
        {**config, "srp_k": K, "batchsize": 8, "reference_batch": 8, "reference_boot_chunk": 10}))
    mix = json.loads((bench / "traffic" / "nsd_rsa_2x6.json").read_text())
    (bench / "traffic" / "tiny_mix.json").write_text(json.dumps(
        {**mix, "regions": ["early visual stream", "V1"], "n_shared": 20, "n_unique": 16,
         "n_voxels": 8, "n_select": 12, "n_bootstrap": 20}))
    (bench / "limits" / "tiny.tiny_mix.json").write_text(json.dumps(
        {"selection_gap": 1e-4, "point_gap": 1e-4, "bootstrap_gap": 1e-4}))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny", "source": "https://example.org/tiny",
                            "file": "portbench/configs/tiny.json", "reduced": [], "why": "a"})
    spec["workloads"].append({"name": "tiny.tiny_mix", "config": "tiny", "traffic": "tiny_mix",
                              "chips": 1, "why": "a"})
    for m in spec["per_layer"]:
        if m["name"] in READERS:
            m["workloads"].append("tiny.tiny_mix")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return cells.load_cell("tiny.tiny_mix", tmp_path)


def _srp_bytes(cell: dict) -> int:
    """2·D·min(D, k) over the cell's distinct tap widths D."""
    model = cells.model(cell)
    size = int(cell["image_size"])
    with torch.device("meta"):
        meta = model.build()
    taps = model.taps(meta, torch.empty((1, 3, size, size), device="meta"), cell["taps"])
    widths = {t[0].numel() for t in taps.values()}
    return sum(2 * d * min(d, int(cell["srp_k"])) for d in widths)


def test_traced_tiny_cell_reads_the_span_metrics(tmp_path, monkeypatch, one_torch_thread):
    from visreps_tpu_torch.core import db

    cell = _tiny_cell(tmp_path)
    assert set(READERS) <= {m["name"] for m in cell["per_layer"]}
    for key in ("VISREPS_RESULTS_DB", "TORCH_WEIGHTS_DIR", "NSD_DATA_DIR", "NSD_STIMULI_HDF5"):
        monkeypatch.setenv(key, "unset")
    (tmp_path / "tmp").mkdir()
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    monkeypatch.setattr(db, "RESULTS_DB_PATH", tmp_path / "tmp" / "results.db")
    out = io.StringIO()
    assert harness.run_cell(cell, 2**31 + 23, 0.1, True, device="cpu", out=out) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    for name in SECONDS:
        assert metrics[name] > 0, name
    assert metrics["srp_drawn_gb"] == pytest.approx(_srp_bytes(cell) / 1e9, rel=1e-12)
    phases = line["eval_phases"]
    assert metrics["model_init_s"] <= sum(p["model_load_s"] for p in phases) / len(phases)
    assert line["metrics"]["srp_drawn_gb"]["unit"] == "GB"


def _ctx(*evals):
    return harness.Context(cell={"root": str(ROOT)}, window_s=1.0,
                           evals=[{"phases": {}, "wall_s": 1.0, "spans": e} for e in evals])


def _rec(id_, parent, name, device_s, **counts):
    return {"id": id_, "parent": parent, "eval": 1, "name": name, "start_ns": 0,
            "end_ns": int(device_s * 2e9), "items": 0, "counts": counts, "device_s": device_s}


EVAL = [
    _rec(0, None, "eval", 10.0),
    _rec(1, 0, "model_load", 3.0), _rec(2, 1, "zoo.init", 2.0),
    _rec(3, 0, "extraction", 6.0), _rec(4, 3, "extractor.batch", 5.0),
    _rec(5, 4, "extractor.forward", 1.5), _rec(6, 4, "extractor.srp_product", 2.5),
    _rec(7, 6, "srp.draw", 0.5, bytes=4_000_000),
    _rec(8, 6, "srp.draw", 0.25, bytes=1_000_000),
    _rec(9, 0, "rsa.exact", 1.0), _rec(10, 9, "extractor.forward", 0.75),
    _rec(11, 0, "zoo.init", 9.0),
]


@pytest.mark.parametrize("name,want", [
    ("model_init_s", 4.0),        # host seconds: (end − start) / 1e9; outside model_load left out
    ("forward_s", 1.5),           # phase 2's forward, outside extraction, left out
    ("srp_product_s", 1.75),      # 2.5 less its draws
    ("srp_draw_s", 0.75),
    ("srp_drawn_gb", 0.005),
])
def test_readers_on_hand_made_records(name, want):
    read = harness.load_reader(name)
    assert read(_ctx(EVAL, EVAL)) == pytest.approx(want)
    assert read(_ctx(EVAL, [r for r in EVAL if r["id"] in (0, 9)])) is None  # one without it


@pytest.mark.parametrize("name", READERS)
def test_readers_silent_without_spans(name):
    """A program without spans: the probe took nothing, nothing is read."""
    assert harness.load_reader(name)(_ctx([], [])) is None


def test_probe_leaves_recording_off_after_close():
    from visreps_tpu_torch.core import profiling

    probe = cells.find("probes", "spans").install()
    with profiling.eval_span():
        with profiling.span("a"):
            pass
    assert [r["name"] for r in probe.take()] == ["eval", "a"]
    probe.close()
    with profiling.span("b"):
        pass
    assert profiling.take_spans() == []
