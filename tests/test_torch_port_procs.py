"""``python -m visreps_tpu_torch.run --procs K`` (subject sharding) against
the JAX package's ``run.py``, on the CPU: the worker argv, a sharded eval
into one results.db equal to the single-process run, and a failing
worker's exit code."""
import argparse
import sqlite3
from pathlib import Path

import numpy as np
import pytest
import torch

from visreps_tpu import run as jrun
from visreps_tpu.core.config import load_config as jax_load_config
from visreps_tpu.core.validate import validate_config as jax_validate

import visreps_tpu_torch.core.db as tdb
from visreps_tpu_torch import run as trun
from visreps_tpu_torch.benchmarks import fixture as tfixture
from visreps_tpu_torch.core.config import load_config

REPO = Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "configs/eval/base.json")
OVERRIDES = [
    "neural_dataset=nsd", "subject_idx=[0,1,2]",
    "region=[early visual stream,ventral visual stream]", "analysis=rsa",
    "compare_method=spearman", "bootstrap=true", "n_bootstrap=8", "n_select=10",
    "batchsize=16", "num_workers=2", "load_model_from=torchvision", "model_name=AlexNet",
    "pretrained_dataset=none", "extract_pre_and_post=true", "srp_k=32",
    "uint8_transfer=true", "log_expdata=true", "seed=1",
]


def _args(procs=2, config=CONFIG, verbose=False, override=OVERRIDES, device=None):
    return argparse.Namespace(mode="eval", procs=procs, config=config, verbose=verbose,
                              override=list(override), device=device)


@pytest.mark.parametrize("procs,verbose,config,device", [
    (2, False, CONFIG, "cpu"), (3, True, None, None), (5, False, CONFIG, "cuda"),
    (1, False, CONFIG, "cpu"),
])
def test_worker_argvs_match_jax(procs, verbose, config, device):
    overrides = OVERRIDES + ["mode=eval"]
    jcfg = jax_validate(jax_load_config(CONFIG, overrides))
    tcfg = trun.validate_config(load_config(CONFIG, overrides))
    want = jrun._shard_worker_argvs(_args(procs, config, verbose), jcfg)
    got = trun._shard_worker_argvs(_args(procs, config, verbose, device=device), tcfg)
    if procs == 1:
        assert got is None and want is None
        return
    assert len(got) == len(want) == min(procs, 3)
    tail = ["--device", device] if device else []
    assert got == [w + tail for w in want]
    assert got[0][got[0].index("--override") + 1] == "acts_retain=true"


def test_worker_argvs_not_sharded():
    single = OVERRIDES[:1] + ["subject_idx=[4]"] + OVERRIDES[2:]
    cfg = trun.validate_config(load_config(CONFIG, single + ["mode=eval"]))
    assert trun._shard_worker_argvs(_args(override=single), cfg) is None


def _rows(path: Path):
    with sqlite3.connect(str(path)) as conn:
        return conn.execute("SELECT region, subject_idx, layer, score, ci_low, ci_high "
                            "FROM results ORDER BY region, subject_idx").fetchall()


@pytest.fixture(scope="module")
def fixture_env(tmp_path_factory):
    """A tiny on-disk NSD fixture (3 subjects) and the environment the
    workers inherit."""
    tmp = tmp_path_factory.mktemp("procs")
    meta = tfixture.ensure_fixture(tmp / "fx", n_shared=12, n_unique=20, n_subjects=3,
                                   n_regions=2, n_voxels=8, img_size=64)
    return tmp, {"NSD_DATA_DIR": str(Path(meta["pickle"]).parent),
                 "NSD_STIMULI_HDF5": meta["stimuli"], "PYTHONPATH": str(REPO)}


def test_sharded_eval_fills_one_db_with_the_single_process_rows(fixture_env, monkeypatch):
    tmp, env = fixture_env
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    sharded_db, single_db = tmp / "sharded.db", tmp / "single.db"
    monkeypatch.setenv("VISREPS_RESULTS_DB", str(sharded_db))

    def no_card():
        raise AssertionError("the --procs parent touched CUDA")

    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "_lazy_init", no_card)
        with pytest.raises(SystemExit) as exc:
            trun.main(["--mode", "eval", "--procs", "2", "--device", "cpu", "--config", CONFIG,
                       "--override", *OVERRIDES])
    assert exc.value.code == 0

    monkeypatch.setattr(tdb, "RESULTS_DB_PATH", single_db)
    results = trun.main(["--mode", "eval", "--device", "cpu", "--config", CONFIG,
                         "--override", *OVERRIDES])
    assert len(results) == 6
    sharded, single = _rows(sharded_db), _rows(single_db)
    assert len(sharded) == len(single) == 6
    for m_row, s_row in zip(sharded, single):
        assert m_row[:3] == s_row[:3]
        np.testing.assert_allclose(m_row[3:], s_row[3:], rtol=0, atol=1e-6)


def test_failing_worker_fails_the_parent(fixture_env, monkeypatch):
    tmp, env = fixture_env
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("VISREPS_RESULTS_DB", str(tmp / "failing.db"))
    with pytest.raises(SystemExit) as exc:  # workers raise: a model outside the port
        trun.main(["--mode", "eval", "--procs", "2", "--device", "cpu", "--config", CONFIG,
                   "--override", *OVERRIDES, "model_name=NotAModel"])
    assert exc.value.code == 1
