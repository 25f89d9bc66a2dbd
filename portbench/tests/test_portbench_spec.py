"""BENCHMARK.json against the benchmark's contract, and the harness
finding every cell's files by name (a new cell needs only new files)."""
from __future__ import annotations

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import cells, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert all(".." not in p and not p.startswith("/") for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert _line(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_unique_names_and_keys():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_every_config_used_and_setup_metric_present():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(cell):
    c = cells.load_cell(cell)
    model, dataset, analysis = cells.model(c), cells.dataset(c), cells.analysis(c)
    assert callable(model.build) and callable(model.taps) and callable(model.install)
    assert callable(dataset.ensure) and callable(dataset.View)
    assert callable(analysis.check) and callable(analysis.control)
    assert set(c["limits"]) == set(analysis.NUMBERS)
    for m in c["per_layer"]:
        assert callable(harness.load_reader(m["name"]))
    assert [m["name"] for m in c["end_to_end"]] == ["images_per_s", "peak_mem_gb", "setup_s"]
    keys = dict(o.split("=", 1) for o in harness.overrides(c, 2**31 + 5))
    assert keys["model_name"] == c["model_name"] and keys["analysis"] == c["analysis"]


def _digest(root: Path) -> dict:
    files = [root / "BENCHMARK.json", *sorted((root / "portbench").rglob("*"))]
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in files if p.is_file()}


NEW_MODEL = """\"\"\"A model added as a file: torchvision AlexNet under a new name.\"\"\"
from portbench.models.alexnet import build, install, overrides, taps  # noqa: F401
"""

NEW_ANALYSIS = """\"\"\"An analysis added as a file: RSA by Spearman, the selection alone
compared.\"\"\"
from portbench.analyses import rsa_spearman as rsa

NUMBERS = ("selection_gap",)
overrides = rsa.overrides
control = rsa.control
device_work_s = rsa.device_work_s


def check(cell, seed, device, sides):
    limits = {**dict.fromkeys(rsa.NUMBERS, float("inf")), **cell["limits"]}
    out = rsa.check({**cell, "limits": limits}, seed, device, sides)
    for side in sides:
        r = out[side]
        r["readings"] = {"selection_gap": r["readings"]["selection_gap"]}
        r["failed"] = int(r["readings"]["selection_gap"] > limits["selection_gap"])
        r["correct"] = r["attempted"] > 0 and r["failed"] == 0
    return out
"""


@pytest.fixture(autouse=False)
def one_torch_thread():
    import torch

    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_new_cell_needs_only_new_files(tmp_path, monkeypatch, one_torch_thread):
    """A model, an analysis, a configuration, a mix, a metric and a cell
    added as new files and entries: every file that was there is
    unchanged, the harness finds them by name, and a whole run of the new
    cell on the CPU at a tiny size reads the new metric and compares the
    new analysis's number."""
    import io

    from visreps_tpu_torch.core import db

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_data", "_cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path)
    bench = tmp_path / "portbench"
    (bench / "models" / "tv_alexnet.py").write_text(NEW_MODEL)
    (bench / "analyses" / "rsa_selection.py").write_text(NEW_ANALYSIS)
    config = json.loads((bench / "configs" / "alexnet.json").read_text())
    (bench / "configs" / "dummy.json").write_text(json.dumps(
        {**config, "model": "tv_alexnet", "srp_k": 32, "batchsize": 8, "reference_batch": 8,
         "reference_boot_chunk": 10}))
    mix = json.loads((bench / "traffic" / "nsd_rsa_2x6.json").read_text())
    (bench / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {**mix, "reference": "rsa_selection", "regions": ["early visual stream", "V1"],
         "n_shared": 20, "n_unique": 16, "n_voxels": 8, "n_select": 12, "n_bootstrap": 20}))
    (bench / "metrics" / "dummy_metric.py").write_text(
        "def read(ctx):\n    return 2.0 * ctx.per_eval('extraction_s')\n")
    (bench / "limits" / "dummy.dummy_mix.json").write_text(json.dumps({"selection_gap": 1e-4}))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dummy", "source": "https://example.org/dummy",
                            "file": "portbench/configs/dummy.json", "reduced": [], "why": "a"})
    spec["workloads"].append({"name": "dummy.dummy_mix", "config": "dummy",
                              "traffic": "dummy_mix", "chips": 1, "why": "a"})
    spec["per_layer"].append({"name": "dummy_metric", "unit": "s", "better": "lower",
                              "source": "program_span", "layer": "extraction",
                              "moves": "images_per_s", "workloads": ["dummy.dummy_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digest(tmp_path)
    assert {k: v for k, v in after.items() if k in before and k != "BENCHMARK.json"} == \
        {k: v for k, v in before.items() if k != "BENCHMARK.json"}

    cell = cells.load_cell("dummy.dummy_mix", tmp_path)
    assert cells.model(cell).__file__ == str(bench / "models" / "tv_alexnet.py")
    assert cells.analysis(cell).NUMBERS == ("selection_gap",)
    assert "dummy_metric" in [m["name"] for m in cell["per_layer"]]
    other = cells.load_cell(BENCH["workloads"][0]["name"], tmp_path)
    assert "dummy_metric" not in [m["name"] for m in other["per_layer"]]

    for key in ("VISREPS_RESULTS_DB", "TORCH_WEIGHTS_DIR", "NSD_DATA_DIR", "NSD_STIMULI_HDF5"):
        monkeypatch.setenv(key, "unset")
    (tmp_path / "tmp").mkdir()
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    monkeypatch.setattr(db, "RESULTS_DB_PATH", tmp_path / "tmp" / "results.db")
    out = io.StringIO()
    assert harness.run_cell(cell, 2**31 + 17, 0.1, True, device="cpu", out=out) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] and list(line["check"]) == ["selection_gap"]
    assert line["metrics"]["dummy_metric"]["value"] == pytest.approx(
        2.0 * line["eval_phases"][0]["extraction_s"], rel=1e-3)
