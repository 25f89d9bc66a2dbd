"""Console printing, the training-metrics CSV and a phase timer (copy of
``visreps_tpu/core/logging.py``; wandb is not ported)."""
from __future__ import annotations

import csv
import os
import sys
import time

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
    """CSV + console training-metrics sink: ``training_metrics.csv`` in
    the checkpoint directory, with the JAX package's (and the
    reference's) columns. ``use_wandb`` only warns: wandb is not ported."""

    FIELDS = ["epoch", "train_loss", "train_acc", "train_top5", "test_acc", "test_top5",
              "learning_rate"]

    def __init__(self, cfg, checkpoint_dir: str | None = None):
        self.cfg = cfg
        self.metrics_file = None
        if checkpoint_dir:
            self.metrics_file = os.path.join(checkpoint_dir, "training_metrics.csv")
            with open(self.metrics_file, "w", newline="") as f:
                csv.DictWriter(f, fieldnames=self.FIELDS).writeheader()
        if cfg.get("use_wandb", False):
            rprint("use_wandb is not ported (ROADMAP.md, 'Training remainder'); "
                   "metrics go to the CSV and the console only", style="warning")

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
        status = f"Epoch [{epoch}/{self.cfg.get('num_epochs', '?')}]"
        if "test_acc" in metrics:
            status += f" Test Acc: {metrics['test_acc']:.2f}%"
            if metrics.get("test_top5") not in ("", None) and not self.cfg.get("pca_labels"):
                status += f" (top5: {metrics['test_top5']:.2f}%)"
        if "train_acc" in metrics:
            status += f" Train Acc: {metrics['train_acc']:.2f}%"
        rprint(status, style="info")


class Timer:
    """Wall-clock phase timer: ``mark(name)`` returns the seconds since
    the previous mark (or construction)."""

    def __init__(self):
        self._start = time.perf_counter()

    def mark(self, name: str) -> float:
        now = time.perf_counter()
        elapsed = now - self._start
        self._start = now
        return elapsed
