"""Training loop (port of ``visreps_tpu/train/trainer.py:35-284``).

Seeded setup, label-smoothed (0.1) cross-entropy, optional gradient
clipping (the gradient norm is reported either way), top-1 / top-5 on
both splits every ``log_interval`` epochs, a checkpoint every
``checkpoint_interval`` epochs (epoch 0 always, when ``log_checkpoints``
is set), and an ETA line after the first epoch. Every family of
``models/zoo.MODEL_REGISTRY`` trains (``model_class=standard_model``,
optionally from IMAGENET1K weights). The forward, backward and update
run on the device; the host reads the loss and the gradient norm once
per step. Evaluation rounds the images to bfloat16 and computes in
float32, as the JAX package's eval step does.

``train_compute_dtype=bf16`` is the JAX package's bf16 step, not
``torch.autocast``: at the loss boundary every float32 parameter and the
images are cast to bfloat16 (``torch.func.functional_call`` on bf16
copies, so the gradients flow back through the casts to the float32
masters), the logits are cast to float32 before the loss, and the
optimizer state and the BatchNorm running statistics stay float32.

Under ``log_checkpoints``, ``save_resume_state`` writes the optimizer
state beside each checkpoint and ``resume_from_epoch=E`` restarts from
epoch E's checkpoint and optimizer state (``train/checkpoint.py``; the
JAX package's own files too) at epoch E + 1, step E × steps_per_epoch.
As in the JAX package, a resumed run draws fresh dropout masks from the
seed and its loaders start their shuffle orders again.

Data parallelism (a ``mesh`` from ``parallel.default_mesh`` under
``torchrun``; the JAX package's GSPMD step, ``trainer.py:136-220``):
every rank reads the same global batch and trains on its
``process_slice`` of it; BatchNorm takes the global batch's statistics
(``models/layers.sync_batch_norm``), dropout the global batch's mask
(``global_batch_rows``; every rank's generator stays in step), and the
gradients and the loss are averaged over the ranks weighted by their
rows before the optimizer step, so each rank makes the single-process
update. Only rank 0 writes checkpoints, metrics and wandb.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch
from torch import nn

from visreps_tpu_torch.core.logging import MetricsLogger, is_interactive_environment, rprint
from visreps_tpu_torch.core.profiling import span
from visreps_tpu_torch.data.augment import augment_batch
from visreps_tpu_torch.data.obj_cls import get_obj_cls_loader
from visreps_tpu_torch.device import resolve_device
from visreps_tpu_torch.models.layers import global_batch_rows, sync_batch_norm
from visreps_tpu_torch.models.zoo import load_model
from visreps_tpu_torch.parallel.feed import local_batch_size, process_slice
from visreps_tpu_torch.parallel.mesh import axis_size, is_writer
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


#: ``train_compute_dtype`` values → the step's compute dtype.
COMPUTE_DTYPES = {None: torch.float32, "f32": torch.float32, "float32": torch.float32,
                  "bf16": torch.bfloat16}


def compute_dtype_of(cfg) -> torch.dtype:
    value = cfg.get("train_compute_dtype")
    if value not in COMPUTE_DTYPES:
        raise ValueError(f"train_compute_dtype={value!r}: use one of "
                         f"{sorted(k for k in COMPUTE_DTYPES if k)} (or leave it unset)")
    return COMPUTE_DTYPES[value]


def forward_logits(model: nn.Module, images: torch.Tensor, generator: torch.Generator | None,
                   compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The model's logits; in bf16, from bf16 copies of its float32
    parameters and of the images (buffers untouched), differentiable
    back to the float32 parameters."""
    if compute_dtype == torch.float32:
        return model(images, generator=generator)[0]
    params = {name: p.to(compute_dtype) if p.dtype == torch.float32 else p
              for name, p in model.named_parameters()}
    logits, _ = torch.func.functional_call(model, params, (images.to(compute_dtype),),
                                           {"generator": generator})
    return logits


def rank_rows(images, labels, mesh):
    """This rank's rows of a host batch under a mesh whose 'data' axis has
    several ranks (``process_slice``): (images, labels, (offset, global
    rows)); the whole batch and None otherwise."""
    if axis_size(mesh) == 1:
        return images, labels, None
    piece = process_slice(len(labels), mesh.get_local_rank("data"), axis_size(mesh))
    return images[piece], labels[piece], (piece.start, len(labels))


def _average_over_ranks(model: nn.Module, loss: torch.Tensor, weight: float,
                        group) -> torch.Tensor:
    """Σ over the group's ranks of ``weight`` (this rank's share of the
    global batch) × its gradients, in place, in one flat all-reduce with
    the loss; returns the global batch's loss."""
    import torch.distributed as dist

    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params] + [loss.detach().reshape(1)])
    flat.mul_(weight)
    dist.all_reduce(flat, group=group)
    offset = 0
    for p in params:
        p.grad.copy_(flat[offset:offset + p.numel()].view_as(p))
        offset += p.numel()
    return flat[-1]


def train_step(model: nn.Module, optimizer: Optimizer, images: torch.Tensor,
               labels: torch.Tensor, generator: torch.Generator | None,
               global_step: int, compute_dtype: torch.dtype = torch.float32,
               group=None, rows: tuple[int, int] | None = None,
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One update: train-mode forward in ``compute_dtype`` (dropout masks
    from ``generator``), float32 loss, backward, the gradient norms and
    the optimizer step. Returns (loss, pre-clip global gradient norm) as
    device tensors.

    Data parallel: ``images`` are rows [offset, offset + len) of a global
    batch of ``total`` rows (``rows=(offset, total)``) and ``group`` the
    ranks that hold the rest; the model's BatchNorms should be synced to
    ``group``. The loss and gradients are then the global batch's."""
    model.train()
    optimizer.zero_grad()
    if rows is None:
        logits = forward_logits(model, images, generator, compute_dtype)
    else:
        with global_batch_rows(*rows):
            logits = forward_logits(model, images, generator, compute_dtype)
    # A rank whose piece of a short last batch is empty still joins every
    # collective, with a zero loss (the mean over no rows would be NaN).
    loss = cross_entropy_loss(logits, labels) if len(labels) else logits.sum() * 0.0
    loss.backward()
    if group is not None:
        loss = _average_over_ranks(model, loss, images.shape[0] / rows[1], group)
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
    is asked for), data parallel over ``mesh``'s 'data' axis when it has
    several ranks."""

    def __init__(self, cfg, device: str | torch.device | None = None, mesh=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh if axis_size(mesh) > 1 else None
        self.group = None if self.mesh is None else self.mesh.get_group("data")
        self._setup()

    def _setup(self):
        cfg = self.cfg
        self.compute_dtype = compute_dtype_of(cfg)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        # Device augmentation: the host loaders stay augment-free.
        self.device_augment = bool(cfg.get("device_augment", False))
        if self.device_augment:
            cfg = cfg.merge({"data_augment": False})

        self.datasets, self.loaders = get_obj_cls_loader(cfg)
        num_classes = (cfg.pca_n_classes if cfg.get("pca_labels")
                       else self.datasets["train"].num_classes)
        self.model = load_model(cfg, num_classes=num_classes, device=self.device)
        if self.group is not None:
            local_batch_size(cfg.batchsize, self.mesh)  # raises unless it divides
            self._broadcast_state()
            sync_batch_norm(self.model, self.group)
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
        self.start_epoch = 1
        writer = is_writer()
        if cfg.get("log_checkpoints"):
            if writer:
                self.checkpoint_dir, self.cfg_dict = ckpt.setup_checkpoint_dir(cfg, self.model)
            if self.group is not None:
                self.checkpoint_dir = self._from_writer(self.checkpoint_dir)
            resume_epoch = cfg.get("resume_from_epoch", 0)
            if resume_epoch:
                self._resume(resume_epoch)
            elif writer:
                ckpt.save_checkpoint(self.checkpoint_dir, 0, self.model, {}, self.cfg_dict)
        self.metrics_logger = MetricsLogger(cfg if writer else cfg.merge({"use_wandb": False}),
                                            self.checkpoint_dir if writer else None)

    def _broadcast_state(self) -> None:
        """Rank 0's parameters and buffers on every rank of the group."""
        import torch.distributed as dist

        src = dist.get_global_rank(self.group, 0)
        for t in self.model.state_dict().values():
            dist.broadcast(t, src, group=self.group)

    def _from_writer(self, value):
        """Rank 0's ``value`` (a picklable object) on every rank."""
        import torch.distributed as dist

        box = [value]
        dist.broadcast_object_list(box, src=dist.get_global_rank(self.group, 0), group=self.group)
        return box[0]

    def _resume(self, epoch: int) -> None:
        """Epoch ``epoch``'s checkpoint (either package's) into the model,
        its optimizer state if saved (else the optimizer starts afresh, as
        in the JAX package), and the step and epoch counters after it."""
        path = os.path.join(self.checkpoint_dir, f"checkpoint_epoch_{epoch}.pth")
        loaded, _ = ckpt.load_checkpoint(path, device=self.device)
        self.model.load_state_dict(loaded.state_dict())
        state = ckpt.load_resume_state(self.checkpoint_dir, epoch, self.optimizer.name)
        if state is not None:
            self.optimizer.load_named_state(state)
        self.global_step = epoch * self.steps_per_epoch
        self.start_epoch = epoch + 1
        rprint(f"Resumed from epoch {epoch} ({path})", style="success")

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
            with span("loader_wait") as wait:
                batch = next(batches, None)
            self.loader_wait_s += wait.seconds
            if batch is None:
                break
            x, y, rows = rank_rows(batch[0], batch[1], self.mesh)
            images = images_to_device(x, self.device)
            if self.device_augment:
                images = augment_batch(images, self.generator)
            loss, grad_norm = train_step(self.model, self.optimizer, images,
                                         labels_to_device(y, self.device),
                                         self.generator, self.global_step, self.compute_dtype,
                                         self.group, rows)
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
        for epoch in range(self.start_epoch, cfg.num_epochs + 1):
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

            if (self.checkpoint_dir and is_writer()
                    and epoch % cfg.get("checkpoint_interval", 5) == 0):
                opt_state = ({"optimizer": self.optimizer.name,
                              "state": self.optimizer.named_state()}
                             if cfg.get("save_resume_state") else None)
                ckpt.save_checkpoint(self.checkpoint_dir, epoch, self.model, metrics,
                                     self.cfg_dict, opt_state=opt_state)

        self.metrics_logger.finish()
        return self.model
