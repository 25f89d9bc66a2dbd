"""Training loop (port of ``visreps_tpu/train/trainer.py:35-284``).

Seeded setup, label-smoothed (0.1) cross-entropy, optional gradient
clipping (the gradient norm is reported either way), top-1 / top-5 on
both splits every ``log_interval`` epochs, a checkpoint every
``checkpoint_interval`` epochs (epoch 0 always, when ``log_checkpoints``
is set), and an ETA line after the first epoch. The forward, backward
and update run on the device; the host reads the loss and the gradient
norm once per step. Evaluation rounds the images to bfloat16 and
computes in float32, as the JAX package's eval step does.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch import nn

from visreps_tpu_torch.core.logging import MetricsLogger, is_interactive_environment, rprint
from visreps_tpu_torch.data.augment import augment_batch
from visreps_tpu_torch.data.obj_cls import get_obj_cls_loader
from visreps_tpu_torch.device import resolve_device
from visreps_tpu_torch.models.zoo import load_model
from visreps_tpu_torch.train import checkpoint as ckpt
from visreps_tpu_torch.train.optim import Optimizer, cross_entropy_loss, lr_at_epoch


def images_to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """(B, H, W, 3) float32 host batch → (B, 3, H, W) on the device."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t.permute(0, 3, 1, 2).contiguous()


def labels_to_device(labels, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.asarray(labels, np.int64))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def train_step(model: nn.Module, optimizer: Optimizer, images: torch.Tensor,
               labels: torch.Tensor, generator: torch.Generator | None,
               global_step: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One update: train-mode forward (dropout masks from ``generator``),
    loss, backward, the gradient norms and the optimizer step. Returns
    (loss, pre-clip global gradient norm) as device tensors."""
    model.train()
    optimizer.zero_grad()
    logits, _ = model(images, generator=generator)
    loss = cross_entropy_loss(logits, labels)
    loss.backward()
    grad_norm = optimizer.step(global_step)
    return loss.detach(), grad_norm


@torch.no_grad()
def eval_step(model: nn.Module, images: torch.Tensor, labels: torch.Tensor):
    """(top-1 hits, top-5 hits) of a batch; images rounded to bfloat16."""
    model.eval()
    logits, _ = model(images.to(torch.bfloat16).to(torch.float32))
    top1 = (logits.argmax(dim=-1) == labels).sum()
    topk = logits.topk(min(5, logits.shape[-1]), dim=-1).indices
    return top1, (topk == labels[:, None]).any(dim=-1).sum()


def calculate_cls_accuracy(loader, model: nn.Module, device: torch.device):
    """Top-1 / top-5 percentages over a loader; top-5 is "" under 5 classes."""
    total = 0
    hits = torch.zeros(2, dtype=torch.int64, device=device)
    for images, labels in loader:
        t1, t5 = eval_step(model, images_to_device(images, device), labels_to_device(labels, device))
        hits += torch.stack([t1, t5])
        total += len(labels)
    if total == 0:
        return 0.0, 0.0
    top1, top5 = (100.0 * h / total for h in hits.tolist())
    return (top1, "") if model.num_classes < 5 else (top1, top5)


class Trainer:
    """Object-classification trainer on ``device`` (CUDA unless ``"cpu"``
    is asked for)."""

    def __init__(self, cfg, device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._setup()

    def _setup(self):
        cfg = self.cfg
        if cfg.get("resume_from_epoch", 0) or cfg.get("save_resume_state"):
            raise NotImplementedError("mid-training resume is not ported yet "
                                      "(ROADMAP.md, 'Training remainder')")
        if (cfg.get("model_class") == "standard_model"
                and cfg.get("model_name", "AlexNet") != "AlexNet"):
            raise NotImplementedError(f"training {cfg.model_name} is not ported yet "
                                      "(ROADMAP.md, 'Training remainder')")
        if cfg.get("train_compute_dtype") not in (None, "f32", "float32"):
            raise NotImplementedError(f"train_compute_dtype={cfg.train_compute_dtype} is not "
                                      "ported yet (ROADMAP.md, 'Training remainder')")
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        # Device augmentation: the host loaders stay augment-free.
        self.device_augment = bool(cfg.get("device_augment", False))
        if self.device_augment:
            cfg = cfg.merge({"data_augment": False})

        self.datasets, self.loaders = get_obj_cls_loader(cfg)
        num_classes = (cfg.pca_n_classes if cfg.get("pca_labels")
                       else self.datasets["train"].num_classes)
        self.model = load_model(cfg, num_classes=num_classes, device=self.device)
        self.steps_per_epoch = max(1, len(self.loaders["train"]))
        mask = self.model.trainable_mask() if hasattr(self.model, "trainable_mask") else None
        self.optimizer = Optimizer(self.model, cfg, self.steps_per_epoch, mask)
        self.global_step = 0
        #: Per step: {"step", "loss", "grad_norm"}, as the host read them.
        self.history: list[dict] = []
        #: Seconds the step loop waited on the train loader.
        self.loader_wait_s = 0.0

        self.checkpoint_dir = None
        self.cfg_dict = None
        if cfg.get("log_checkpoints"):
            self.checkpoint_dir, self.cfg_dict = ckpt.setup_checkpoint_dir(cfg, self.model)
            ckpt.save_checkpoint(self.checkpoint_dir, 0, self.model, {}, self.cfg_dict)
        self.metrics_logger = MetricsLogger(cfg, self.checkpoint_dir)

    def evaluate(self, split: str = "test"):
        # Tiny-ImageNet's loaders are keyed "val"
        if split not in self.loaders and split == "test" and "val" in self.loaders:
            split = "val"
        return calculate_cls_accuracy(self.loaders[split], self.model, self.device)

    def train_epoch(self, epoch: int):
        total_loss = total_grad_norm = 0.0
        n = 0
        lr = lr_at_epoch(self.cfg, epoch - 1)
        batches = iter(self.loaders["train"])
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            self.loader_wait_s += time.perf_counter() - t0
            if batch is None:
                break
            images = images_to_device(batch[0], self.device)
            if self.device_augment:
                images = augment_batch(images, self.generator)
            loss, grad_norm = train_step(self.model, self.optimizer, images,
                                         labels_to_device(batch[1], self.device),
                                         self.generator, self.global_step)
            self.global_step += 1
            n += 1
            loss, grad_norm = torch.stack([loss, grad_norm]).tolist()  # one host read
            self.history.append({"step": self.global_step, "loss": loss, "grad_norm": grad_norm})
            total_loss += loss
            total_grad_norm += grad_norm
        avg = total_loss / max(n, 1)
        return avg, {"epoch_loss": avg, "learning_rate": lr,
                     "grad_norm": total_grad_norm / max(n, 1)}

    def train(self) -> nn.Module:
        start = time.time()
        cfg = self.cfg
        for epoch in range(1, cfg.num_epochs + 1):
            epoch_loss, epoch_metrics = self.train_epoch(epoch)
            metrics = {"epoch": epoch, "epoch_metrics": epoch_metrics}

            if epoch == 1 and is_interactive_environment():
                eta = (time.time() - start) * (cfg.num_epochs - 1)
                h, m = int(eta // 3600), int((eta % 3600) // 60)
                rprint(f"Estimated time remaining: {f'{h}h {m}m' if h else f'{m}m'}")

            if epoch % cfg.get("log_interval", 1) == 0:
                for split in ("test", "train"):
                    top1, top5 = self.evaluate(split)
                    metrics[f"{split}_acc"] = top1
                    metrics[f"{split}_top5"] = top5
                self.metrics_logger.log_metrics(epoch, epoch_loss, metrics)

            if self.checkpoint_dir and epoch % cfg.get("checkpoint_interval", 5) == 0:
                ckpt.save_checkpoint(self.checkpoint_dir, epoch, self.model, metrics,
                                     self.cfg_dict)
        return self.model
