"""Curriculum fine-tuning: source → target label-granularity transfer
(port of ``experiments/coarse_grain_benefits/curriculum_finetuning.py``).

Load a cfg{source} checkpoint, replace the classifier head with a fresh
one of the target granularity (the model family's own init, drawn from
``torch.Generator().manual_seed(seed)``), freeze layers per the transfer
mode (full / late_layers / fc_only / head_only: the frozen layers'
parameters are left out of the optimizer, ``train/optim.py``, as the JAX
package's optax mask zeroes their updates, and their BatchNorm keeps its
running statistics), fine-tune on ImageNet with the target labels (PCA
CSV when the target is not 1000), evaluate every ``eval_freq`` epochs,
and write checkpoints named ``cfg{source}_to_{target}_{mode}_{seed
letter}`` plus a metrics CSV. The learning rate follows the framework's
warm-up + cosine table, read per step (``Optimizer.lr_at_step``).

It runs on one card. The JAX script shards each batch over
``parallel.auto.default_mesh``; the port has no multi-GPU counterpart
of that yet.

Usage:
  python -m visreps_tpu_torch.experiments.coarse_grain_benefits.curriculum_finetuning \\
      --source-cfg-id 64 --target-cfg-id 1000 --transfer-mode late_layers \\
      --checkpoint-dir /data/ckpts/alexnet_pca --seed 1 [--device cpu]
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import time

import torch
from torch import nn

from visreps_tpu_torch.core.config import Config, get_seed_letter
from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.device import resolve_device

# Reference: curriculum_finetuning.py:79-100 — trainable-layer strings.
TRANSFER_MODES = {
    "full": {"conv": "11111", "fc": "111",
             "description": "Train all layers (standard fine-tuning)"},
    "late_layers": {"conv": "00001", "fc": "111",
                    "description": "Freeze conv1-4, train conv5 + fc"},
    "fc_only": {"conv": "00000", "fc": "111",
                "description": "Freeze all conv, train only fc layers"},
    "head_only": {"conv": "00000", "fc": "001",
                  "description": "Freeze everything except the head"},
}


def replace_classifier_head(model: nn.Module, target_classes: int, transfer_mode: str,
                            seed: int) -> nn.Module:
    """A new model of ``model``'s family with a fresh ``fc3`` head of
    ``target_classes`` and the transfer mode's trainability; every other
    parameter and BatchNorm statistic is ``model``'s. On ``model``'s
    device, in eval mode."""
    mode = TRANSFER_MODES[transfer_mode]
    new = type(model)(num_classes=target_classes, conv_trainable=mode["conv"],
                      fc_trainable=mode["fc"])
    new.init_weights(torch.Generator().manual_seed(seed))
    kept = {k: v for k, v in model.state_dict().items() if not k.startswith("fc3.")}
    missing, unexpected = new.load_state_dict(kept, strict=False)
    if unexpected or any(not k.startswith("fc3.") for k in missing):
        raise ValueError(f"head swap: missing {missing}, unexpected {unexpected}")
    device = next(model.parameters()).device
    return new.to(device).eval()


def finetune_optimizer(model: nn.Module, args, steps_per_epoch: int):
    """AdamW with global-norm clipping (1.0) and the warm-up + cosine
    table over the model's trainable layers."""
    from visreps_tpu_torch.train.optim import Optimizer

    train_cfg = Config({
        "optimizer": "adamw", "learning_rate": args.learning_rate,
        "weight_decay": args.weight_decay, "grad_clip": 1.0,
        "lr_scheduler": "cosineannealinglr", "num_epochs": args.num_epochs,
        "warmup_epochs": args.warmup_epochs,
    })
    return Optimizer(model, train_cfg, steps_per_epoch, model.trainable_mask())


def run_curriculum_finetuning(args) -> list[dict]:
    from visreps_tpu_torch.data.obj_cls import get_obj_cls_loader
    from visreps_tpu_torch.models.zoo import load_model
    from visreps_tpu_torch.train import checkpoint as ckpt
    from visreps_tpu_torch.train.trainer import (
        calculate_cls_accuracy,
        images_to_device,
        labels_to_device,
        train_step,
    )

    device = resolve_device(args.device)
    seed_letter = get_seed_letter(args.seed)
    exp_name = f"cfg{args.source_cfg_id}_to_{args.target_cfg_id}_{args.transfer_mode}_{seed_letter}"
    exp_dir = os.path.join(args.output_dir, exp_name)
    os.makedirs(exp_dir, exist_ok=True)
    rprint(f"Curriculum: {args.source_cfg_id}-way -> {args.target_cfg_id}-way "
           f"({args.transfer_mode}, seed {args.seed}) -> {exp_dir}", style="info")

    # Load source, swap head, set trainability.
    src_cfg = Config({
        "load_model_from": "checkpoint", "seed": args.seed,
        "cfg_id": args.source_cfg_id, "checkpoint_dir": args.checkpoint_dir,
        "checkpoint_model": args.checkpoint_model,
    })
    model = replace_classifier_head(load_model(src_cfg, device=device), args.target_cfg_id,
                                    args.transfer_mode, args.seed)

    # Data with target-granularity labels.
    data_cfg = Config({
        "dataset": "imagenet", "batchsize": args.batch_size,
        "num_workers": args.num_workers,
        "pca_labels": args.target_cfg_id != 1000,
        "pca_n_classes": args.target_cfg_id,
        "pca_labels_folder": args.pca_labels_folder,
        "data_augment": True, "seed": args.seed,
    })
    _, loaders = get_obj_cls_loader(data_cfg)
    optimizer = finetune_optimizer(model, args, max(1, len(loaders["train"])))

    config = {
        "source_cfg_id": args.source_cfg_id, "target_cfg_id": args.target_cfg_id,
        "seed": args.seed, "num_epochs": args.num_epochs,
        "learning_rate": args.learning_rate, "weight_decay": args.weight_decay,
        "batch_size": args.batch_size, "warmup_epochs": args.warmup_epochs,
        "transfer_mode": args.transfer_mode,
        "transfer_mode_config": TRANSFER_MODES[args.transfer_mode],
        "total_params": int(sum(p.numel() for p in model.parameters())),
    }
    with open(os.path.join(exp_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)

    results = []

    def evaluate_now(epoch, train_loss, lr):
        top1, top5 = calculate_cls_accuracy(loaders["test"], model, device)
        rprint(f"  epoch {epoch}: top1 {top1:.2f}% top5 {top5}", style="highlight")
        results.append({
            "source_cfg_id": args.source_cfg_id, "target_cfg_id": args.target_cfg_id,
            "seed": args.seed, "transfer_mode": args.transfer_mode,
            "epoch": epoch, "train_loss": train_loss,
            "val_top1": top1, "val_top5": top5, "learning_rate": lr,
        })
        return top1

    evaluate_now(0, None, args.learning_rate)
    ckpt.save_checkpoint(exp_dir, 0, model, {"val_top1": results[-1]["val_top1"]}, config)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    step = 0
    start = time.time()
    for epoch in range(1, args.num_epochs + 1):
        total = n = 0
        for images, labels in loaders["train"]:
            loss, _ = train_step(model, optimizer, images_to_device(images, device),
                                 labels_to_device(labels, device), generator, step)
            step += 1
            total += float(loss)
            n += 1
        train_loss = total / max(n, 1)
        rprint(f"Epoch {epoch}/{args.num_epochs}: loss {train_loss:.4f} "
               f"({time.time()-start:.0f}s elapsed)", style="info")
        if epoch % args.eval_freq == 0 or epoch == args.num_epochs:
            evaluate_now(epoch, train_loss, args.learning_rate)
        ckpt.save_checkpoint(exp_dir, epoch, model, {"train_loss": train_loss}, config)

    csv_path = os.path.join(exp_dir, "metrics.csv")
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(results[0].keys()))
        writer.writeheader()
        writer.writerows(results)
    rprint(f"Metrics -> {csv_path}", style="success")
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--source-cfg-id", type=int, default=64)
    parser.add_argument("--target-cfg-id", type=int, default=1000)
    parser.add_argument("--checkpoint-dir", required=True,
                        help="dir holding cfg{source}{seed_letter}/")
    parser.add_argument("--checkpoint-model", default="checkpoint_epoch_20.pth")
    parser.add_argument("--pca-labels-folder", default="pca_labels_alexnet")
    parser.add_argument("--seed", type=int, default=1, choices=[1, 2, 3])
    parser.add_argument("--num-epochs", type=int, default=10)
    parser.add_argument("--learning-rate", type=float, default=0.002)
    parser.add_argument("--weight-decay", type=float, default=0.0001)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--num-workers", type=int, default=8)
    parser.add_argument("--warmup-epochs", type=int, default=1)
    parser.add_argument("--transfer-mode", default="full", choices=list(TRANSFER_MODES))
    parser.add_argument("--eval-freq", type=int, default=2)
    parser.add_argument("--output-dir",
                        default="experiments/coarse_grain_benefits/results/curriculum_checkpoints")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    return run_curriculum_finetuning(args)


if __name__ == "__main__":
    main()
