"""CLI: python -m visreps_tpu_torch.run --mode train|eval [--config PATH]
[--override k=v ...] [--device cpu]

Reads the same JSON configs as ``python -m visreps_tpu.run`` (default
``configs/{mode}/base.json``) and trains (``--mode train``) or runs the
NSD RSA eval (``--mode eval``) on the card, or on the CPU with
``--device cpu``. Validation covers what this port runs.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from visreps_tpu_torch.core.config import Config, load_config
from visreps_tpu_torch.core.logging import rprint

_NSD_REGIONS = {"early visual stream", "ventral visual stream",
                "V1", "V2", "V3", "hV4", "FFA", "PPA"}
_DATASETS = {"imagenet", "tiny-imagenet", "imagenet-mini-10", "imagenet-mini-50",
             "imagenet-mini-200"}
_MODEL_CLASSES = {"custom_model", "standard_model"}


def validate_config(cfg: Config) -> Config:
    """The JAX package's checks (``core/validate.py``) for the mode."""
    if cfg.get("mode") == "train":
        return _validate_train(cfg)
    if cfg.get("mode") != "eval":
        raise ValueError(f"Invalid mode: {cfg.get('mode')}")
    return _validate_eval(cfg)


def _validate_train(cfg: Config) -> Config:
    """Dataset and model-class whitelists, ``pca_labels`` present,
    trainability masks of 0/1, ``pca_n_classes`` a power of two above 1,
    batch size 64 by default."""
    if cfg.get("dataset") not in _DATASETS:
        raise ValueError(f"Invalid dataset: {cfg.get('dataset')}")
    if cfg.get("model_class") not in _MODEL_CLASSES:
        raise ValueError(f"Invalid model_class: {cfg.get('model_class')}")
    if "pca_labels" not in cfg:
        raise ValueError("pca_labels flag must be specified")
    other = "custom_model" if cfg.model_class == "standard_model" else "standard_model"
    if other in cfg:
        raise ValueError(f"{other} key should not be present in {cfg.model_class} mode")
    if cfg.model_class == "custom_model":
        arch = cfg.get("arch", Config())
        for key in ("conv_trainable", "fc_trainable"):
            if not all(c in "01" for c in arch.get(key, "")):
                raise ValueError(f"{key} must only contain '0's and '1's")
        tiny = "tiny" in cfg.get("model_name", "").lower()
        if cfg.get("dataset") == "imagenet" and tiny:
            rprint("Training TinyCustomCNN on ImageNet-1k (designed for TinyImageNet)", style="warning")
        elif cfg.get("dataset") == "tiny-imagenet" and not tiny:
            rprint("Training CustomCNN on TinyImageNet (designed for ImageNet-1k)", style="warning")
    if cfg.pca_labels:
        n = cfg.get("pca_n_classes", 0)
        if n <= 1:
            raise ValueError("pca_n_classes must be greater than 1 when pca_labels is True")
        if n & (n - 1):
            raise ValueError("pca_n_classes must be a power of 2")
    if "batchsize" not in cfg:
        cfg.batchsize = 64
        rprint("Using default batch size: 64", style="info")
    return cfg


def _validate_eval(cfg: Config) -> Config:
    """Seed, subjects, regions, method, analysis, return nodes, model
    source and the checkpoint's existence; subject_idx / region become
    lists."""
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
    if cfg.load_model_from == "checkpoint":
        from visreps_tpu_torch.models.zoo import checkpoint_path

        if "torchvision" in cfg:
            raise ValueError("torchvision key not allowed in checkpoint mode")
        if not Path(checkpoint_path(cfg)).exists():
            raise ValueError(f"Checkpoint not found: {checkpoint_path(cfg)}")
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

    if cfg.mode == "train":
        from visreps_tpu_torch.train.trainer import Trainer

        trainer = Trainer(cfg, device=args.device)
        trainer.train()
        return trainer

    from visreps_tpu_torch import evals

    return evals.eval(cfg, device=args.device)


if __name__ == "__main__":
    main()
