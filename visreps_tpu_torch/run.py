"""CLI: python -m visreps_tpu_torch.run --mode eval [--config PATH]
[--override k=v ...] [--device cpu]

Reads the same JSON configs as ``python -m visreps_tpu.run`` (default
``configs/eval/base.json``) and runs the NSD RSA eval on the card, or on
the CPU with ``--device cpu``. Validation covers what this port runs.
"""
from __future__ import annotations

import argparse

from visreps_tpu_torch.core.config import Config, load_config

_NSD_REGIONS = {"early visual stream", "ventral visual stream",
                "V1", "V2", "V3", "hV4", "FFA", "PPA"}


def validate_config(cfg: Config) -> Config:
    """The JAX package's eval checks (core/validate.py) for the NSD RSA
    slice: seed, subjects, regions, method, analysis, return nodes and
    model source. Normalises subject_idx / region to lists."""
    if cfg.get("mode") != "eval":
        raise NotImplementedError("--mode train is not ported yet (ROADMAP.md, 'Training')")
    if cfg.get("seed") not in (1, 2, 3):
        raise ValueError(f"Invalid seed: {cfg.get('seed')}. Must be one of [1, 2, 3]")
    for key in ("subject_idx", "region"):
        if not isinstance(cfg.get(key), list):
            cfg[key] = [cfg.get(key)]
    if cfg.get("neural_dataset", "").lower() == "nsd":
        for s in cfg.subject_idx:
            if not isinstance(s, int) or not 0 <= s < 8:
                raise ValueError(f"Invalid subject index for NSD: {s}. Must be an integer in range [0, 7]")
        for r in cfg.region:
            if r not in _NSD_REGIONS:
                raise ValueError(f"Invalid region for NSD: {r}. Must be one of {_NSD_REGIONS}")
    if cfg.get("compare_method", "spearman").lower() not in {"spearman", "kendall"}:
        raise ValueError(f"Invalid compare_method: {cfg.get('compare_method')}")
    if cfg.get("analysis", "").lower() not in {"rsa", "encoding_score"}:
        raise ValueError(f"Invalid analysis: {cfg.get('analysis')}")
    if not list(cfg.get("return_nodes") or []):
        raise ValueError("return_nodes list cannot be empty")
    if cfg.get("load_model_from") not in {"checkpoint", "torchvision"}:
        raise ValueError("load_model_from must be 'checkpoint' or 'torchvision'")
    return cfg


def main(argv=None):
    parser = argparse.ArgumentParser(description="visreps PyTorch/CUDA port")
    parser.add_argument("--mode", choices=["train", "eval"], default="eval")
    parser.add_argument("--config", default=None)
    parser.add_argument("--override", nargs="*", default=[])
    parser.add_argument("--device", default=None,
                        help="'cpu' to run on the CPU; default is the CUDA card")
    parser.add_argument("--verbose", "-v", action="store_true")
    args = parser.parse_args(argv)

    overrides = list(args.override)
    if args.verbose:
        overrides.append("verbose=true")
    overrides.append(f"mode={args.mode}")
    cfg = validate_config(load_config(args.config or f"configs/{args.mode}/base.json", overrides))

    from visreps_tpu_torch import evals

    return evals.eval(cfg, device=args.device)


if __name__ == "__main__":
    main()
