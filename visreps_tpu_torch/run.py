"""CLI: python -m visreps_tpu_torch.run --mode train|eval [--config PATH]
[--override k=v ...] [--device cpu] [--procs K]

Reads the same JSON configs as ``python -m visreps_tpu.run`` (default
``configs/{mode}/base.json``) and trains (``--mode train``) or runs an
eval (``--mode eval``: ``neural_dataset`` nsd, tvsd, things-behavior or
nsd_synthetic; ``analysis=rsa``, or ``analysis=encoding_score`` on nsd
and tvsd) on the card, or on the CPU with ``--device cpu``. Validation
covers what this port runs.

``--procs K`` splits a multi-subject eval's subjects over K worker
processes (``subjects[i::K]``), each this CLI with ``--procs 1``, all
writing one WAL results.db. Workers retain phase-1 rows
(``acts_retain=true``, first, so a user's override wins) and intersect
the shared test ids over the full subject list
(``shared_test_subjects``), so their rows are the single process's. The
parent validates the config and waits; it never touches the card.

Under ``torchrun`` (``WORLD_SIZE`` > 1) each rank joins one process
group — NCCL on ``cuda:LOCAL_RANK``, or gloo with ``--device cpu`` —
with a ``DIST_TIMEOUT_S`` (600 s) timeout on every collective, and the
('data', 'model') mesh of ``parallel.default_mesh`` goes to the trainer
and the eval: every rank computes the single-process results and rank 0
alone writes them. A rank that raises exits non-zero, and torchrun stops
the others. ``--procs`` cannot be combined with several ranks:

  torchrun --nproc_per_node K -m visreps_tpu_torch.run --mode eval ...
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

from visreps_tpu_torch.core.config import Config, load_config
from visreps_tpu_torch.core.logging import rprint

_NSD_REGIONS = {"early visual stream", "ventral visual stream",
                "V1", "V2", "V3", "hV4", "FFA", "PPA"}
_TVSD_REGIONS = {"V1", "V4", "IT"}
_NEURAL_DATASETS = {"nsd", "things-behavior", "tvsd", "nsd_synthetic"}
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
    """Seed, dataset, its subjects and regions, method, analysis, return
    nodes, model source and the checkpoint's existence. subject_idx /
    region become lists, or "N/A" for things-behavior; encoding_score
    (nsd and tvsd only) sets compare_method to pearson."""
    if cfg.get("seed") not in (1, 2, 3):
        raise ValueError(f"Invalid seed: {cfg.get('seed')}. Must be one of [1, 2, 3]")
    dataset = cfg.get("neural_dataset", "").lower()
    if dataset not in _NEURAL_DATASETS:
        raise ValueError(f"Invalid neural_dataset: {dataset}")
    if dataset == "things-behavior":
        for key in ("region", "subject_idx"):
            val = cfg.get(key)
            if val is not None and not (isinstance(val, str) and val.upper() == "N/A"):
                rprint(f"{key}={val!r} ignored for things-behavior; set to 'N/A'", style="warning")
                cfg[key] = "N/A"
    else:
        for key in ("subject_idx", "region"):
            if not isinstance(cfg.get(key), list):
                cfg[key] = [cfg.get(key)]
    if dataset in ("nsd", "nsd_synthetic"):
        for s in cfg.subject_idx:
            if not isinstance(s, int) or not 0 <= s < 8:
                raise ValueError(f"Invalid subject index for NSD: {s}. Must be an integer in range [0, 7]")
        for r in cfg.region:
            if r not in _NSD_REGIONS:
                raise ValueError(f"Invalid region for NSD: {r}. Must be one of {_NSD_REGIONS}")
    if dataset == "tvsd":
        for s in cfg.subject_idx:
            if not isinstance(s, int) or s not in (0, 1):
                raise ValueError(f"Invalid subject_idx for TVSD: {s}. Must be 0 (monkey F) or 1 (monkey N)")
        for r in cfg.region:
            if r not in _TVSD_REGIONS:
                raise ValueError(f"Invalid region for TVSD: {r}. Must be one of {_TVSD_REGIONS}")
    if cfg.get("compare_method", "spearman").lower() not in {"spearman", "kendall"}:
        raise ValueError(f"Invalid compare_method: {cfg.get('compare_method')}")
    analysis = cfg.get("analysis", "").lower()
    if analysis not in {"rsa", "encoding_score"}:
        raise ValueError(f"Invalid analysis: {cfg.get('analysis')}")
    if analysis == "encoding_score":
        if dataset in ("things-behavior", "nsd_synthetic"):
            raise ValueError(f"analysis=encoding_score is not supported for {dataset}. "
                             "Use analysis=rsa instead.")
        cfg.compare_method = "pearson"  # the encoding metric; part of the run_id
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


def _shard_worker_argvs(args, cfg) -> list[list[str]] | None:
    """argv of each subject-shard worker, or None where sharding does not
    apply (``--procs`` 1, train mode, or a single subject)."""
    if args.procs <= 1 or args.mode != "eval":
        return None
    subjects = cfg.get("subject_idx")
    if not isinstance(subjects, list) or len(subjects) <= 1:
        return None
    n = min(args.procs, len(subjects))
    full = json.dumps(list(cfg.get("shared_test_subjects") or subjects), separators=(",", ":"))
    argvs = []
    for i in range(n):
        shard = json.dumps(subjects[i::n], separators=(",", ":"))
        overrides = ["acts_retain=true", *args.override, f"subject_idx={shard}",
                     f"shared_test_subjects={full}"]
        argv = ["--mode", "eval", "--procs", "1", "--override", *overrides]
        if args.config:
            argv += ["--config", args.config]
        if args.verbose:
            argv += ["--verbose"]
        if args.device:
            argv += ["--device", args.device]
        argvs.append(argv)
    return argvs


def _run_sharded(argvs: list[list[str]]) -> int:
    """Start every worker, wait for all; 1 if any failed, else 0."""
    procs = [subprocess.Popen([sys.executable, "-m", "visreps_tpu_torch.run", *a])
             for a in argvs]
    rc = 0
    for a, p in zip(argvs, procs):
        if p.wait() != 0:
            print(f"subject-shard worker failed (rc={p.returncode}): {a}", file=sys.stderr)
            rc = 1
    return rc


#: Seconds a collective may wait before the process group fails it, so
#: that a lost rank ends the run instead of hanging it.
DIST_TIMEOUT_S = 600


def init_distributed(device: str | None):
    """Join the process group torchrun describes (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``) and return this
    rank's device: ``cuda:LOCAL_RANK`` over NCCL, or the CPU over gloo
    when ``device`` is "cpu". CUDA without NCCL raises: no collective
    falls back to gloo or the host."""
    import torch
    import torch.distributed as dist

    if device is not None and torch.device(device).type == "cpu":
        backend, dev = "gloo", "cpu"
    else:
        if not dist.is_nccl_available():
            raise RuntimeError("several ranks on CUDA need NCCL, which this torch lacks; "
                               "pass --device cpu for gloo ranks on the CPU")
        dev = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        torch.cuda.set_device(dev)
        backend = "nccl"
    dist.init_process_group(backend, timeout=timedelta(seconds=DIST_TIMEOUT_S))
    return dev


def main(argv=None):
    parser = argparse.ArgumentParser(description="visreps PyTorch/CUDA port")
    parser.add_argument("--mode", choices=["train", "eval"], default="eval")
    parser.add_argument("--config", default=None)
    parser.add_argument("--override", nargs="*", default=[])
    parser.add_argument("--device", default=None,
                        help="'cpu' to run on the CPU; default is the CUDA card")
    parser.add_argument("--verbose", "-v", action="store_true")
    parser.add_argument("--procs", type=int, default=1,
                        help="split an eval's subjects over K worker processes "
                             "(one shared results.db)")
    args = parser.parse_args(argv)

    overrides = list(args.override)
    if args.verbose:
        overrides.append("verbose=true")
    overrides.append(f"mode={args.mode}")
    cfg = validate_config(load_config(args.config or f"configs/{args.mode}/base.json", overrides))

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and args.procs > 1:
        raise ValueError(f"--procs {args.procs} shards subjects over processes; it cannot run "
                         f"under torchrun's {world} ranks")
    worker_argvs = _shard_worker_argvs(args, cfg)
    if worker_argvs:
        if cfg.get("log_expdata"):
            from visreps_tpu_torch.core.db import init_db

            # The workers share one WAL results.db, made here before they
            # start: two first connections switching a new file to WAL at
            # once can fail one with "database is locked".
            init_db(os.environ.get("VISREPS_RESULTS_DB", "results.db")).close()
        raise SystemExit(_run_sharded(worker_argvs))

    device, mesh = args.device, None
    if world > 1:
        from visreps_tpu_torch.parallel.auto import default_mesh

        device = init_distributed(args.device)
        mesh = default_mesh(cfg)
    try:
        if cfg.mode == "train":
            from visreps_tpu_torch.train.trainer import Trainer

            trainer = Trainer(cfg, device=device, mesh=mesh)
            trainer.train()
            return trainer

        from visreps_tpu_torch import evals

        return evals.eval(cfg, device=device, mesh=mesh)
    finally:
        if world > 1:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
