"""Train sweep CLI (port of ``visreps_tpu/runners/train_runner.py``):

    python -m visreps_tpu_torch.runners.train_runner --grid configs/grids/train_grid.json
        [--config PATH] [--jobs N] [--dry-run] [--device cpu]

Exits 0 when every run exited 0 (``base_runner.exit_code``).
"""
from __future__ import annotations

import argparse

from visreps_tpu_torch.runners.base_runner import ExperimentRunner, exit_code


def main(argv=None):
    parser = argparse.ArgumentParser(description="Run training sweeps from a grid JSON")
    parser.add_argument("--grid", required=True, help="Path to grid JSON (configs/grids/...)")
    parser.add_argument("--config", default=None, help="Base config (default configs/train/base.json)")
    parser.add_argument("--jobs", type=int, default=1)
    parser.add_argument("--dry-run", action="store_true")
    parser.add_argument("--device", default=None,
                        help="passed to every run: 'cpu' for the CPU; default is the CUDA card")
    args = parser.parse_args(argv)

    runner = ExperimentRunner(
        mode="train", grid_path=args.grid, config=args.config,
        jobs=args.jobs, dry_run=args.dry_run, device=args.device,
    )
    raise SystemExit(exit_code(runner.run_all()))


if __name__ == "__main__":
    main()
