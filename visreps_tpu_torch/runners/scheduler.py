"""Sweep schedulers: the training matrix and the eval fan-out (port of
``visreps_tpu/runners/scheduler.py``).

``TRAIN_PARAM_GRID`` (seeds × PCA granularities × label sources, with
``checkpoint_dir`` derived from the label source) and
``EVAL_PARAM_GRID``, one ``python -m visreps_tpu_torch.run`` job per
combo, on the card unless ``--device cpu`` is passed through. Backends:

  * ``--backend print`` (default): print each command;
  * ``--backend slurm``: write one sbatch script per job (one GPU each,
    ``--gres=gpu:1``) and submit it;
  * ``--backend local``: run the jobs as subprocesses of this host, at
    most ``--jobs`` at a time. Every job inherits this process's
    environment unchanged: nothing assigns a job its own card, so on a
    host with several cards set ``CUDA_VISIBLE_DEVICES`` per run
    yourself (``ExperimentRunner``'s ``env_per_job``).
"""
from __future__ import annotations

import argparse
import itertools
import os
import subprocess
import sys
from pathlib import Path

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.runners.base_runner import RUN_MODULE

TRAIN_PARAM_GRID = {
    "seed": [1, 2, 3],
    "pca_n_classes": [2, 4, 8, 16, 32, 64],
    "pca_labels_folder": [
        "pca_labels_alexnet",
        "pca_labels_clip",
        "pca_labels_dino",
        "pca_labels_vit",
    ],
}

EVAL_PARAM_GRID = {
    "seed": [1, 2, 3],
    "cfg_id": [2, 4, 8, 16, 32, 64],
    "analysis": ["rsa"],
    "compare_method": ["spearman"],
}

DEFAULT_PARTITION = "gpu"


def expand_grid(grid: dict) -> list[dict]:
    keys = list(grid)
    return [dict(zip(keys, vals)) for vals in itertools.product(*(grid[k] for k in keys))]


def train_overrides(combo: dict) -> dict:
    """checkpoint_dir derives from the label source."""
    source = combo["pca_labels_folder"].replace("pca_labels_", "")
    return {
        "seed": combo["seed"],
        "pca_labels": True,
        "pca_n_classes": combo["pca_n_classes"],
        "pca_labels_folder": combo["pca_labels_folder"],
        "checkpoint_dir": f"pca_{source}",
        "log_checkpoints": True,
    }


def generate_slurm_script(job_name: str, command: str, out_dir: Path,
                          partition: str = DEFAULT_PARTITION, time_limit: str = "08:00:00",
                          cpus: int = 32) -> Path:
    script = f"""#!/bin/bash
#SBATCH --job-name={job_name}
#SBATCH --partition={partition}
#SBATCH --gres=gpu:1
#SBATCH --time={time_limit}
#SBATCH --cpus-per-task={cpus}
#SBATCH --output={out_dir}/{job_name}.%j.out

{command}
"""
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{job_name}.sh"
    path.write_text(script)
    return path


def _command(mode: str, overrides: dict, config: str | None, device: str | None = None) -> str:
    parts = [sys.executable, "-m", RUN_MODULE, "--mode", mode]
    if config:
        parts += ["--config", config]
    parts += ["--override"] + [f"{k}={v}" for k, v in overrides.items()]
    if device:
        parts += ["--device", device]
    return " ".join(str(p) for p in parts)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Submit the training/eval sweep matrix")
    parser.add_argument("--mode", choices=["train", "eval"], default="train")
    parser.add_argument("--backend", choices=["slurm", "local", "print"], default="print")
    parser.add_argument("--config", default=None)
    parser.add_argument("--partition", default=DEFAULT_PARTITION)
    parser.add_argument("--jobs", type=int, default=1, help="local backend concurrency")
    parser.add_argument("--out-dir", default="slurm_scripts")
    parser.add_argument("--device", default=None,
                        help="passed to every run: 'cpu' for the CPU; default is the CUDA card")
    args = parser.parse_args(argv)

    grid = TRAIN_PARAM_GRID if args.mode == "train" else EVAL_PARAM_GRID
    combos = expand_grid(grid)
    rprint(f"{len(combos)} jobs in the {args.mode} matrix", style="info")

    procs = []
    for i, combo in enumerate(combos):
        overrides = train_overrides(combo) if args.mode == "train" else dict(combo)
        cmd = _command(args.mode, overrides, args.config, args.device)
        name = f"{args.mode}_{i:03d}"
        if args.backend == "print":
            print(cmd)
        elif args.backend == "slurm":
            script = generate_slurm_script(name, cmd, Path(args.out_dir), args.partition)
            subprocess.run(["sbatch", str(script)], check=False)
        else:  # local
            procs.append(subprocess.Popen(cmd.split(), env=dict(os.environ)))
            if len(procs) >= args.jobs:
                procs.pop(0).wait()
    for p in procs:
        p.wait()


if __name__ == "__main__":
    main()
