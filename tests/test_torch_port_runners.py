"""The port's sweep runners (``visreps_tpu_torch/runners``) against the
JAX package's (``visreps_tpu/runners``), on the CPU: grid expansion on
the paper's grids and a nested toy grid, value formatting, every runner
and scheduler command (the JAX package's with the module name swapped,
plus ``--device`` where it is passed), the ``eval_checkpoint_at_epoch``
mapping, the SLURM script's text, the local backend's environment, that
``dry_run`` launches nothing, exit codes and retries; and one real
training run through ``train_runner`` with ``--device cpu``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from visreps_tpu.runners import base_runner as jbase
from visreps_tpu.runners import eval_runner as jeval
from visreps_tpu.runners import scheduler as jsched
from visreps_tpu.runners import train_runner as jtrain

from visreps_tpu_torch.runners import base_runner as tbase
from visreps_tpu_torch.runners import eval_runner as teval
from visreps_tpu_torch.runners import scheduler as tsched
from visreps_tpu_torch.runners import train_runner as ttrain

REPO = Path(__file__).resolve().parents[1]
GRIDS = sorted((REPO / "configs" / "grids").glob("*.json"))
NESTED = [
    {"seed": [1, 2], "arch": {"dropout": [0.0, 0.5], "pooling_type": "max"},
     "custom_model": {"arch": {"conv_trainable": ["11111", "00111"]}}, "notes": "a"},
    {"cfg_id": 4, "region": "V1"},
]


def _swap(cmd: list[str], device: str | None = None) -> list[str]:
    """A JAX package command as the port runs it."""
    out = ["visreps_tpu_torch.run" if c == "visreps_tpu.run" else c for c in cmd]
    return out + (["--device", device] if device else [])


class Recorder:
    """Stands in for subprocess.run / Popen: records each command and
    environment, returns the next code of ``codes`` (0 when used up)."""

    def __init__(self, codes=()):
        self.calls, self.codes = [], list(codes)
        self.returncode = 0

    def run(self, cmd, env=None, **kwargs):
        self.calls.append((list(cmd), env))
        return subprocess.CompletedProcess(cmd, self.codes.pop(0) if self.codes else 0)

    def popen(self, cmd, env=None, **kwargs):
        self.calls.append((list(cmd), env))
        return self

    def wait(self):
        return 0


@pytest.fixture
def recorder(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(subprocess, "run", rec.run)
    monkeypatch.setattr(subprocess, "Popen", rec.popen)
    return rec


def _exit(main, argv) -> int:
    with pytest.raises(SystemExit) as e:
        main(argv)
    return e.value.code


# ── grids and commands ──

@pytest.mark.parametrize("grid", [*GRIDS, "nested"], ids=lambda g: getattr(g, "name", g))
def test_load_param_grid_matches_jax(grid, tmp_path):
    if grid == "nested":
        grid = tmp_path / "nested.json"
        grid.write_text(json.dumps(NESTED))
    combos = tbase.load_param_grid(grid)
    assert combos == jbase.load_param_grid(grid)
    if grid.name in ("train_grid.json", "eval_grid.json"):
        assert len(combos) == 18  # 3 seeds × 6 PCA granularities
    if grid.name == "nested.json":
        assert len(combos) == 2 * 2 * 2 + 1
        assert combos[0]["arch.pooling_type"] == "max"
        assert combos[-1] == {"cfg_id": 4, "region": "V1"}


@pytest.mark.parametrize("value", [True, False, 3, 2.5, "spearman", [0, 1], ["V1", "IT"],
                                   {"a": 1}, None])
def test_fmt_value_matches_jax(value):
    assert tbase._fmt_value(value) == jbase._fmt_value(value)


@pytest.mark.parametrize("device", [None, "cpu"])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: g.name)
def test_experiment_runner_commands(grid, device):
    kw = dict(grid_path=grid, config="configs/eval/base.json",
              extra_overrides={"log_expdata": True, "region": ["V1", "V2"]})
    t = tbase.ExperimentRunner("eval", device=device, **kw)
    j = jbase.ExperimentRunner("eval", **kw)
    assert t.combos == j.combos
    for combo in t.combos:
        assert t._command(combo) == _swap(j._command(combo), device)
    assert t._command(t.combos[0])[:3] == [sys.executable, "-m", "visreps_tpu_torch.run"]


@pytest.mark.parametrize("device", [None, "cpu"])
@pytest.mark.parametrize("runner", ["train", "eval"])
def test_runner_clis_launch_the_jax_commands(recorder, runner, device):
    """Each CLI launches one subprocess per combo, the JAX package's
    command with the module swapped (``--device`` appended where given);
    eval runs map eval_checkpoint_at_epoch to checkpoint_model and carry
    log_expdata=true load_model_from=checkpoint."""
    grid = str(REPO / "configs" / "grids" / f"{runner}_grid.json")
    tmain, jmain = (ttrain.main, jtrain.main) if runner == "train" else (teval.main, jeval.main)
    assert _exit(jmain, ["--grid", grid]) == 0
    jcalls = [c for c, _ in recorder.calls]
    recorder.calls.clear()
    assert _exit(tmain, ["--grid", grid] + (["--device", device] if device else [])) == 0
    tcalls = [c for c, _ in recorder.calls]
    assert len(tcalls) == 18 and tcalls == [_swap(c, device) for c in jcalls]
    if runner == "eval":
        for cmd in tcalls:
            overrides = cmd[cmd.index("--override") + 1:len(cmd) - (2 if device else 0)]
            assert "checkpoint_model=checkpoint_epoch_20.pth" in overrides
            assert not any(a.startswith("eval_checkpoint_at_epoch") for a in overrides)
            assert overrides[-2:] == ["log_expdata=true", "load_model_from=checkpoint"]


@pytest.mark.parametrize("runner", [ttrain.main, teval.main])
def test_dry_run_launches_nothing(monkeypatch, runner, capsys):
    def refuse(*args, **kwargs):
        raise AssertionError("dry_run launched a process")

    monkeypatch.setattr(subprocess, "run", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    name = "train" if runner is ttrain.main else "eval"
    grid = str(REPO / "configs" / "grids" / f"{name}_grid.json")
    assert _exit(runner, ["--grid", grid, "--dry-run", "--device", "cpu"]) == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if "visreps_tpu_torch.run" in l]
    assert len(lines) == 18 and all(l.endswith("--device cpu") for l in lines)


def test_exit_codes_retries_and_jobs(monkeypatch, tmp_path):
    grid = tmp_path / "g.json"
    grid.write_text(json.dumps({"seed": [1, 2, 3]}))
    rec = Recorder(codes=[1, 0, 0, 2, 2])
    monkeypatch.setattr(subprocess, "run", rec.run)
    runner = tbase.ExperimentRunner("train", grid_path=grid, retries=1,
                                    env_per_job=lambda i: {"JOB": str(i)})
    assert runner.run_all() == [0, 0, 2]  # combo 1: fails, retried; combo 3: fails twice
    assert [env["JOB"] for _, env in rec.calls] == ["0", "0", "1", "2", "2"]
    assert tbase.exit_code([0, 0]) == 0 and tbase.exit_code([0, 2, 1]) == 2
    assert tbase.exit_code([0, -9]) == 9 and tbase.exit_code([]) == 0  # killed by a signal
    rec = Recorder()
    monkeypatch.setattr(subprocess, "run", rec.run)
    assert tbase.ExperimentRunner("train", grid_path=grid, jobs=3).run_all() == [0, 0, 0]
    assert sorted(c[-1] for c, _ in rec.calls) == ["seed=1", "seed=2", "seed=3"]


# ── scheduler ──

def test_scheduler_grids_match_jax():
    assert tsched.TRAIN_PARAM_GRID == jsched.TRAIN_PARAM_GRID
    assert tsched.EVAL_PARAM_GRID == jsched.EVAL_PARAM_GRID
    for grid in (tsched.TRAIN_PARAM_GRID, tsched.EVAL_PARAM_GRID):
        assert tsched.expand_grid(grid) == jsched.expand_grid(grid)
    combos = tsched.expand_grid(tsched.TRAIN_PARAM_GRID)
    assert len(combos) == 72
    assert [tsched.train_overrides(c) for c in combos] == \
        [jsched.train_overrides(c) for c in combos]
    assert tsched.train_overrides(combos[1])["checkpoint_dir"] == "pca_clip"


@pytest.mark.parametrize("device", [None, "cpu"])
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_scheduler_print_backend(capsys, mode, device):
    jsched.main(["--mode", mode, "--config", "c.json"])
    jlines = [l for l in capsys.readouterr().out.splitlines() if "-m visreps_tpu.run" in l]
    tsched.main(["--mode", mode, "--config", "c.json"] + (["--device", device] if device else []))
    tlines = [l for l in capsys.readouterr().out.splitlines() if "-m visreps_tpu_torch.run" in l]
    assert len(tlines) == (72 if mode == "train" else 18)
    tail = f" --device {device}" if device else ""
    assert tlines == [l.replace("-m visreps_tpu.run ", "-m visreps_tpu_torch.run ") + tail
                      for l in jlines]


def test_slurm_script_text(tmp_path):
    """The JAX package's script with one GPU asked for and a GPU
    partition by default: the one place the texts differ."""
    out = tmp_path / "scripts"
    j = jsched.generate_slurm_script("train_000", "python x", out)
    jtext = j.read_text()
    t = tsched.generate_slurm_script("train_000", "python x", out)
    ttext = t.read_text()
    assert t == j
    assert ttext == f"""#!/bin/bash
#SBATCH --job-name=train_000
#SBATCH --partition=gpu
#SBATCH --gres=gpu:1
#SBATCH --time=08:00:00
#SBATCH --cpus-per-task=32
#SBATCH --output={out}/train_000.%j.out

python x
"""
    expected = jtext.replace("--partition=tpu", "--partition=gpu").replace(
        "#SBATCH --time", "#SBATCH --gres=gpu:1\n#SBATCH --time")
    assert ttext == expected


def test_scheduler_slurm_backend(recorder, tmp_path):
    out = tmp_path / "scripts"
    tsched.main(["--mode", "eval", "--backend", "slurm", "--out-dir", str(out),
                 "--partition", "h100", "--device", "cpu"])
    assert [c for c, _ in recorder.calls] == [["sbatch", str(out / f"eval_{i:03d}.sh")]
                                              for i in range(18)]
    text = (out / "eval_017.sh").read_text()
    assert "#SBATCH --partition=h100" in text and "#SBATCH --gres=gpu:1" in text
    assert "-m visreps_tpu_torch.run --mode eval --override seed=3 cfg_id=64" in text
    assert text.rstrip().endswith("--device cpu")


def test_scheduler_local_backend_environment(recorder, monkeypatch):
    """Every local job inherits this process's environment unchanged: no
    per-job device variable, as in the JAX package's code."""
    monkeypatch.setenv("MARKER", "1")
    tsched.main(["--mode", "eval", "--backend", "local", "--jobs", "4"])
    tcalls = list(recorder.calls)
    recorder.calls.clear()
    jsched.main(["--mode", "eval", "--backend", "local", "--jobs", "4"])
    assert len(tcalls) == 18
    assert [c for c, _ in tcalls] == [_swap(c) for c, _ in recorder.calls]
    assert all(env == dict(os.environ) for _, env in tcalls)


# ── one real run ──

def test_train_runner_runs_a_combo_on_the_cpu(tmp_path, monkeypatch):
    """One combo of a toy PCA-label grid through ``train_runner`` with
    ``--device cpu``: one ``python -m visreps_tpu_torch.run`` subprocess
    that exits 0 and writes its checkpoint."""
    rng = np.random.RandomState(0)
    labels = []
    for split, n in (("train", 4), ("val", 2)):
        for c in range(2):
            d = tmp_path / "data" / split / f"class{c}"
            d.mkdir(parents=True)
            for i in range(n):
                img = rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
                Image.fromarray(img).save(d / f"{split}{c}{i}.JPEG")
                labels.append(f"{split}{c}{i}.JPEG,{(c + i) % 2}")
    pca = tmp_path / "pca"
    pca.mkdir()
    (pca / "n_classes_2.csv").write_text("image,pca_label\n" + "\n".join(labels) + "\n")
    ckpt = tmp_path / "ckpt"
    grid = tmp_path / "grid.json"
    grid.write_text(json.dumps({
        "seed": 1, "pca_labels": True, "pca_n_classes": [2], "pca_labels_folder": str(pca),
        "checkpoint_dir": str(ckpt), "log_checkpoints": True, "dataset": "tiny-imagenet",
        "dataset_path": str(tmp_path / "data"), "model_name": "TinyCustomCNN",
        "num_epochs": 1, "warmup_epochs": 0, "batchsize": 4, "num_workers": 2,
        "log_interval": 1, "checkpoint_interval": 1}))
    monkeypatch.setenv("PYTHONPATH", str(REPO))
    monkeypatch.chdir(tmp_path)
    assert _exit(ttrain.main, ["--grid", str(grid), "--device", "cpu",
                               "--config", str(REPO / "configs/train/base.json")]) == 0
    assert (ckpt / "cfg2a" / "checkpoint_epoch_1.pth").is_file()
    assert (ckpt / "cfg2a" / "config.json").is_file()
