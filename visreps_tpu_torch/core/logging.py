"""Console printing and the training-metrics CSV with an optional wandb
sink (copy of ``visreps_tpu/core/logging.py``, without its phase timer:
the port's phases are ``core.profiling`` spans)."""
from __future__ import annotations

import csv
import os
import sys

_STYLES = {
    "info": "\033[1;37m",
    "success": "\033[32m",
    "warning": "\033[1;33m",
    "error": "\033[1;31m",
    "highlight": "\033[1;35m",
    "setup": "\033[36m",
}
_RESET = "\033[0m"


def is_interactive_environment() -> bool:
    if os.environ.get("SLURM_JOB_ID") is not None:
        return False
    try:
        return sys.stdout.isatty()
    except (AttributeError, ValueError):
        return False


def rprint(msg: str = "", style: str | None = None) -> None:
    if style in _STYLES and is_interactive_environment():
        print(f"{_STYLES[style]}{msg}{_RESET}")
    else:
        print(msg)


class MetricsLogger:
    """CSV + console (+ optional wandb) training-metrics sink:
    ``training_metrics.csv`` in the checkpoint directory, with the JAX
    package's (and the reference's) columns. With ``use_wandb`` it
    imports wandb when constructed and calls ``wandb.init`` with the JAX
    package's arguments (entity visreps, project = dataset, group
    ``seed_{seed}``, name ``{model_name}_{model_class}``, the config);
    ``log_metrics`` logs its keys and ``finish`` ends the run. A failure
    (no wandb, offline) warns and turns wandb off."""

    FIELDS = ["epoch", "train_loss", "train_acc", "train_top5", "test_acc", "test_top5",
              "learning_rate"]

    def __init__(self, cfg, checkpoint_dir: str | None = None):
        self.cfg = cfg
        self.metrics_file = None
        if checkpoint_dir:
            self.metrics_file = os.path.join(checkpoint_dir, "training_metrics.csv")
            with open(self.metrics_file, "w", newline="") as f:
                csv.DictWriter(f, fieldnames=self.FIELDS).writeheader()
        self.use_wandb = bool(cfg.get("use_wandb", False))
        self._wandb = None
        if self.use_wandb:
            try:
                import wandb  # noqa: PLC0415

                self._wandb = wandb
                wandb.init(
                    entity="visreps",
                    project=cfg.get("dataset", "visreps_tpu"),
                    group=f"seed_{cfg.get('seed')}",
                    name=f"{cfg.get('model_name')}_{cfg.get('model_class')}",
                    config=cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg),
                )
            except Exception as e:  # wandb is optional, and may be offline
                rprint(f"W&B initialization failed: {e}", style="warning")
                self.use_wandb = False

    def log_metrics(self, epoch: int, loss: float, metrics: dict) -> None:
        if self.metrics_file:
            row = {
                "epoch": metrics.get("epoch", epoch),
                "train_loss": loss,
                "train_acc": metrics.get("train_acc", ""),
                "train_top5": metrics.get("train_top5", ""),
                "test_acc": metrics.get("test_acc", ""),
                "test_top5": metrics.get("test_top5", ""),
                "learning_rate": metrics.get("epoch_metrics", {}).get("learning_rate", ""),
            }
            with open(self.metrics_file, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=self.FIELDS).writerow(row)
        if self.use_wandb:
            try:
                log = {"epoch": epoch, "training/test-acc": metrics.get("test_acc")}
                if "train_acc" in metrics:
                    log["training/train-acc"] = metrics["train_acc"]
                if not self.cfg.get("pca_labels"):
                    for k in ("test_top5", "train_top5"):
                        if k in metrics:
                            log[f"training/{k.replace('_', '-')}"] = metrics[k]
                self._wandb.log(log)
            except Exception as e:
                rprint(f"W&B logging failed: {e}", style="warning")
        status = f"Epoch [{epoch}/{self.cfg.get('num_epochs', '?')}]"
        if "test_acc" in metrics:
            status += f" Test Acc: {metrics['test_acc']:.2f}%"
            if metrics.get("test_top5") not in ("", None) and not self.cfg.get("pca_labels"):
                status += f" (top5: {metrics['test_top5']:.2f}%)"
        if "train_acc" in metrics:
            status += f" Train Acc: {metrics['train_acc']:.2f}%"
        rprint(status, style="info")

    def finish(self) -> None:
        if self.use_wandb:
            try:
                self._wandb.finish()
            except Exception as e:
                rprint(f"W&B finish failed: {e}", style="warning")
