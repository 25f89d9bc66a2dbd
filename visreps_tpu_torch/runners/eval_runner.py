"""Eval sweep CLI (port of ``visreps_tpu/runners/eval_runner.py``):

    python -m visreps_tpu_torch.runners.eval_runner --grid configs/grids/eval_grid.json
        [--config PATH] [--jobs N] [--dry-run] [--device cpu]

Injects ``log_expdata=True load_model_from=checkpoint`` and maps
``eval_checkpoint_at_epoch`` → ``checkpoint_model``. Exits 0 when every
run exited 0 (``base_runner.exit_code``).
"""
from __future__ import annotations

import argparse

from visreps_tpu_torch.runners.base_runner import ExperimentRunner, exit_code


def main(argv=None):
    parser = argparse.ArgumentParser(description="Run evaluation sweeps from a grid JSON")
    parser.add_argument("--grid", required=True)
    parser.add_argument("--config", default=None)
    parser.add_argument("--jobs", type=int, default=1)
    parser.add_argument("--dry-run", action="store_true")
    parser.add_argument("--device", default=None,
                        help="passed to every run: 'cpu' for the CPU; default is the CUDA card")
    args = parser.parse_args(argv)

    runner = ExperimentRunner(
        mode="eval", grid_path=args.grid, config=args.config,
        extra_overrides={"log_expdata": True, "load_model_from": "checkpoint"},
        jobs=args.jobs, dry_run=args.dry_run, device=args.device,
    )
    for combo in runner.combos:
        if "eval_checkpoint_at_epoch" in combo:
            epoch = combo.pop("eval_checkpoint_at_epoch")
            combo["checkpoint_model"] = f"checkpoint_epoch_{epoch}.pth"
    raise SystemExit(exit_code(runner.run_all()))


if __name__ == "__main__":
    main()
