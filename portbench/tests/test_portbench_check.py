"""Whole runs of the harness on the CPU at a tiny size (the look for a
card skipped), the comparison seeing each fault a cell can have, and, on
the card, the control: the reference with TF32 on in the program's place
must come out not correct at the cell's own size."""
from __future__ import annotations

import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import cells, harness
from portbench.analyses import rsa_spearman

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 99


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def tiny_cell(tmp_path_factory):
    """The first cell with AlexNet, SRP k = 32 and 52 stimuli."""
    cell = cells.load_cell("vgg16.nsd_rsa_2x6")
    cell.update(json.loads((ROOT / "portbench" / "configs" / "alexnet.json").read_text()))
    cell.update(srp_k=32, batchsize=8, reference_batch=8, reference_boot_chunk=10,
                subjects=[0, 1], regions=["early visual stream", "V1"], n_shared=20,
                n_unique=16, n_voxels=8, n_select=12, n_bootstrap=20,
                fixture_dir=str(tmp_path_factory.mktemp("fixture")))
    return cell


def _run(cell, tmp_path, monkeypatch, trace=False) -> dict:
    from visreps_tpu_torch.core import db

    for key in ("VISREPS_RESULTS_DB", "TORCH_WEIGHTS_DIR", "NSD_DATA_DIR", "NSD_STIMULI_HDF5"):
        monkeypatch.setenv(key, "unset")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(db, "RESULTS_DB_PATH", tmp_path / "results.db")
    out = io.StringIO()
    assert harness.run_cell(cell, SEED, 0.1, trace, device="cpu", out=out) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_sound_run_is_correct(tiny_cell, tmp_path, monkeypatch):
    line = _run(tiny_cell, tmp_path, monkeypatch, trace=True)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] == 4
    assert list(line)[-1] == "check"
    assert all(v["value"] <= v["limit"] for v in line["check"].values())
    assert {"model_load_s", "extraction_s", "scoring_s"} <= set(line["metrics"])
    assert "mfu" not in line["metrics"]  # no card: no RDM reached the kernel


def test_answer_altered_where_produced(tiny_cell, tmp_path, monkeypatch):
    from visreps_tpu_torch import evals

    orig = evals._report

    def report(cfg, pair_list, layer_of, point_of, boot_of, sel_scores):
        point_of = dict(point_of)
        point_of[pair_list[0]] += 0.01
        return orig(cfg, pair_list, layer_of, point_of, boot_of, sel_scores)

    monkeypatch.setattr(evals, "_report", report)
    line = _run(tiny_cell, tmp_path, monkeypatch)
    assert not line["correct"] and line["check"]["point_gap"]["value"] > 0.009


def test_layer_choice_altered(tiny_cell, tmp_path, monkeypatch):
    from visreps_tpu_torch import evals

    orig = evals._report

    def report(cfg, pair_list, layer_of, point_of, boot_of, sel_scores):
        region, subj = pair_list[0]
        scores = {d["layer"]: d["score"] for d in sel_scores[region][subj]}
        worst = min(scores, key=scores.get)
        layer_of = {r: dict(v) for r, v in layer_of.items()}
        layer_of[region][subj] = worst
        return orig(cfg, pair_list, layer_of, point_of, boot_of, sel_scores)

    monkeypatch.setattr(evals, "_report", report)
    line = _run(tiny_cell, tmp_path, monkeypatch)
    assert not line["correct"] and line["check"]["selection_gap"]["value"] > 1e-3


def test_half_the_batch_left_out(tiny_cell, tmp_path, monkeypatch):
    """Each batch's second half replaced by the mean of its first half."""
    from visreps_tpu_torch.models.extractor import FeatureExtractor

    orig = FeatureExtractor._srp_rows

    def half(self, x):
        rows = orig(self, x)
        h = max(1, len(x) // 2)
        return {k: torch.cat([v[:h], v[:h].mean(0, keepdim=True).expand(len(v) - h, -1)])
                for k, v in rows.items()}

    monkeypatch.setattr(FeatureExtractor, "_srp_rows", half)
    line = _run(tiny_cell, tmp_path, monkeypatch)
    assert not line["correct"] and line["check"]["selection_gap"]["value"] > 1e-3


def test_plan_is_the_programs(tiny_cell, tmp_path, monkeypatch):
    from visreps_tpu_torch import evals
    from visreps_tpu_torch.data.neural import load_all_nsd_data

    _run(tiny_cell, tmp_path, monkeypatch)  # writes the fixture
    cell = dict(tiny_cell, n_select=5)
    ref = rsa_spearman.Reference(cell, SEED, "cpu")
    monkeypatch.setenv("NSD_DATA_DIR", cell["fixture_dir"])
    monkeypatch.setenv("NSD_STIMULI_HDF5", str(Path(cell["fixture_dir"]) / "nsd_stimuli.npy"))
    data = load_all_nsd_data(None, subjects=cell["subjects"], regions=cell["regions"])
    theirs = evals._selection_plan(data["neural"], cell["subjects"], cell["regions"],
                                   data["stimuli"], 5)
    mine = ref.plan()
    assert all(theirs[(r, s)] == mine[s] for r in cell["regions"] for s in cell["subjects"])
    assert ref.data.test_ids == data["shared_test_ids"]


def test_without_a_card_no_result(tmp_path):
    """Only BENCHMARK.json and the benchmark's files, and no card: a
    non-zero exit and no result line."""
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_data", "_cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "vgg16.nsd_rsa_2x6",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and '"correct"' not in p.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_control_is_not_correct(cell_name):
    """The cell's control (for RSA the reference with TF32 on) in the
    program's place, at the cell's own size and limits, one seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    cell = cells.load_cell(cell_name)
    cells.dataset(cell).ensure(cell, Path(cell["fixture_dir"]))
    seed = 2**31 + 4242
    analysis = cells.analysis(cell)
    control = analysis.control(cell, seed, "cuda")
    torch.cuda.empty_cache()
    check = analysis.check(cell, seed, "cuda", {"control": [control]})["control"]
    assert not check["correct"], check["readings"]
    assert np.isfinite(list(check["readings"].values())).all()
