"""``visreps_tpu_torch.explore_results`` (sqlite3, no pandas) against the
JAX package's pandas dashboard, on one results.db seeded through the
port's ``core/db.save_results``."""
import math

import pytest

from visreps_tpu import explore_results as jexplore

import visreps_tpu_torch.core.db as tdb
from visreps_tpu_torch import explore_results as texplore
from visreps_tpu_torch.config import ConfigDict
from visreps_tpu_torch.core.config import Config


def _result(layer, score, boot=True, selection=True):
    r = {"layer": layer, "score": score, "ci_low": score - 0.1, "ci_high": score + 0.1,
         "analysis": "rsa", "compare_method": "spearman"}
    if boot:
        r["bootstrap_scores"] = [score - 0.05, score, score + 0.05]
    if selection:
        r["layer_selection_scores"] = [{"layer": "conv1", "score": 0.1},
                                       {"layer": layer, "score": score}]
    return r


@pytest.fixture(scope="module")
def db_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("explore") / "results.db"
    base = {"epoch": -1, "cfg_id": "untrained", "pca_labels": False, "pca_n_classes": None,
            "pca_labels_folder": None, "checkpoint_dir": None, "model_name": "AlexNet",
            "reconstruct_from_pcs": False, "pca_k": 1}
    runs = [
        ({"neural_dataset": "nsd", "analysis": "rsa", "compare_method": "spearman", "seed": 1,
          "subject_idx": s, "region": r}, _result(f"conv{s + 2}_post", 0.2 + 0.01 * s))
        for s in range(3) for r in ("V1", "early visual stream")
    ] + [
        ({"neural_dataset": "nsd", "analysis": "rsa", "compare_method": "spearman", "seed": 2,
          "subject_idx": 0, "region": "V1"}, _result("fc1_pre", 0.31, boot=False)),
        ({"neural_dataset": "things-behavior", "analysis": "rsa", "compare_method": "spearman",
          "seed": 1, "subject_idx": "N/A", "region": "N/A"}, _result("conv5_post", 0.44)),
        ({"neural_dataset": "tvsd", "analysis": "encoding_score", "compare_method": "pearson",
          "seed": 3, "subject_idx": 1, "region": "IT", "cfg_id": 32},
         _result("fc2_post", 0.51, selection=False)),
    ]
    for identity, row in runs:
        tdb.save_results([row], Config({**base, **identity}), db_path=path)
    return path


def _same(got, want):
    """Row lists (or dicts) equal, NaN equal to None (pandas' NULL)."""
    def norm(v):
        return None if isinstance(v, float) and math.isnan(v) else v
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert norm(got[k]) == norm(want[k]) or got[k] == want[k], k
        return
    assert len(got) == len(want) and len(got) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert norm(g[k]) == norm(w[k]), (k, g[k], w[k])


def test_summary(db_path):
    _same(texplore.summary(db_path), jexplore.summary(db_path).to_dict("records"))


@pytest.mark.parametrize("dataset,analysis", [
    ("nsd", "rsa"), ("things-behavior", "rsa"), ("tvsd", "encoding_score"), ("tvsd", "rsa"),
    ("nsd_synthetic", "rsa"),
])
def test_completeness(db_path, dataset, analysis, capsys):
    got = texplore.completeness(dataset, analysis, db_path)
    got_line = capsys.readouterr().out
    want = jexplore.completeness(dataset, analysis, db_path).to_dict("records")
    assert got_line == capsys.readouterr().out
    _same(got, want)
    assert texplore.EXPECTED_ANATOMY == jexplore.EXPECTED_ANATOMY


@pytest.mark.parametrize("name", ["db_info", "distinct_values", "health"])
def test_dict_commands(db_path, name, capsys):
    got = getattr(texplore, name)(db_path)
    got_out = capsys.readouterr().out
    want = getattr(jexplore, name)(db_path)
    assert got_out == capsys.readouterr().out
    _same(got, want)


@pytest.mark.parametrize("n", [3, 20])
def test_recent(db_path, n):
    _same(texplore.recent(n, db_path), jexplore.recent(n, db_path).to_dict("records"))


def test_run_sql(db_path):
    q = "SELECT region, subject_idx, layer, score FROM results ORDER BY score"
    _same(texplore.run_sql(q, db_path), jexplore.run_sql(q, db_path).to_dict("records"))


def test_default_path_and_missing_db(db_path, tmp_path, monkeypatch):
    monkeypatch.setattr(tdb, "RESULTS_DB_PATH", db_path)
    assert texplore.summary() == texplore.summary(db_path)
    with pytest.raises(FileNotFoundError):
        texplore.summary(tmp_path / "absent.db")


def test_main_prints_aligned_tables(db_path, capsys):
    texplore.main(["completeness", "--db", str(db_path)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("nsd/rsa: 7/192")
    assert lines[1].split() == ["region", "subject", "seed1", "seed2", "seed3"]
    assert len(lines) == 2 + 64 and "x" in lines[2]
    texplore.main(["sql", "SELECT layer, score FROM results WHERE seed = 3", "--db", str(db_path)])
    header, row = capsys.readouterr().out.splitlines()
    assert header.split() == ["layer", "score"] and row.split() == ["fc2_post", "0.51"]
    assert len(header) == len(row)  # the number is right-aligned under its header
    texplore.main(["all", "--db", str(db_path)])
    assert "== RECENT (10) ==" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        texplore.main(["sql", "--db", str(db_path)])


def test_config_shim():
    cfg = ConfigDict({"a": {"b": 1}})
    assert ConfigDict is Config and cfg.a.b == 1
