"""Standalone feature-extraction CLI → .npz for the offline analyses (port
of ``visreps_tpu/analysis/extract_representations.py``).

Model activations over an ImageNet-layout dataset, with SRP, with conv
taps globally average-pooled, or exact; saved as one .npz with a key per
layer plus ``image_ids``.

Usage:
  python -m visreps_tpu_torch.analysis.extract_representations \\
      --model AlexNet --dataset imagenet --dataset-path DIR \\
      --return-nodes conv5 fc1 fc2 --srp-k 4096 --out feats.npz [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
from torch import nn

from visreps_tpu_torch.core.config import Config, get_seed_letter
from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.device import resolve_device


class _WithIds:
    """A labelled dataset yielding (image, image id) instead of labels."""

    def __init__(self, base):
        self.base = base

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx):
        img, _ = self.base[idx]
        return img, self.base.samples[idx][2]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="AlexNet")
    parser.add_argument("--pretrained-dataset", default="none")
    parser.add_argument("--load-from", default="standard", choices=["standard", "checkpoint"])
    parser.add_argument("--checkpoint-dir", default="checkpoints")
    parser.add_argument("--cfg-id", type=int, default=1)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--checkpoint-model", default="checkpoint_epoch_20.pth")
    parser.add_argument("--dataset", default="imagenet")
    parser.add_argument("--dataset-path", default=None)
    parser.add_argument("--label-file", default=None,
                        help="wnid → label JSON (default: IMAGENET_LOCAL_DIR/folder_labels.json)")
    parser.add_argument("--return-nodes", nargs="+", default=["conv5", "fc1", "fc2"])
    parser.add_argument("--no-pre-post", action="store_true")
    parser.add_argument("--srp-k", type=int, default=4096, help="0 disables SRP")
    parser.add_argument("--spatial-pool", action="store_true",
                        help="global-average-pool conv taps (exact mode)")
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--out", default="features.npz")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from visreps_tpu_torch.data.loader import PrefetchLoader
    from visreps_tpu_torch.data.obj_cls import get_obj_cls_loader

    device = resolve_device(args.device)
    cfg = Config({"dataset": args.dataset, "dataset_path": args.dataset_path,
                  "label_file": args.label_file, "batchsize": args.batch_size,
                  "num_workers": 16, "pca_labels": False, "data_augment": False})
    datasets, _ = get_obj_cls_loader(cfg, shuffle=False, train_test_split=False)
    loader = PrefetchLoader(_WithIds(datasets["all"]), batch_size=args.batch_size,
                            shuffle=False, num_workers=16)

    if args.load_from == "checkpoint":
        from visreps_tpu_torch.train.checkpoint import load_checkpoint

        path = os.path.join(args.checkpoint_dir, f"cfg{args.cfg_id}{get_seed_letter(args.seed)}",
                            args.checkpoint_model)
        model, _ = load_checkpoint(path, device=device)
    else:
        from visreps_tpu_torch.models.zoo import init_model

        model = init_model(args.model, 1000, seed=0, device=device)
        if args.pretrained_dataset == "imagenet1k":
            from visreps_tpu_torch.models.torch_import import load_pretrained_torch

            model = load_pretrained_torch(model, args.model, 1000)

    acts, ids = extract_representations(model, loader, args.return_nodes,
                                        pre_and_post=not args.no_pre_post, srp_k=args.srp_k,
                                        spatial_pool=args.spatial_pool, device=device)
    np.savez(args.out, image_ids=np.asarray(ids), **acts)
    rprint(f"Saved {args.out}: {list(acts)} x {len(ids)} images", style="success")
    return 0


def extract_representations(model: nn.Module, loader, return_nodes, pre_and_post: bool = True,
                            srp_k: int = 4096, spatial_pool: bool = False,
                            image_size: int = 224, device: str | torch.device | None = None):
    """({layer: (N, D) float32 array}, ids) by one of three variants:

      * srp_k > 0: SRP on the device (FeatureExtractor.get_activations);
      * srp_k = 0 with spatial_pool: each layer's post-ReLU tap, a conv
        tap averaged over H × W (``models/pooling.py``, pool size 1);
      * srp_k = 0: the exact flattened taps, all layers in one pass.
    """
    from visreps_tpu_torch.models.extractor import FeatureExtractor

    device = resolve_device(device)
    model = model.to(device).eval()
    if srp_k > 0:
        extractor = FeatureExtractor(model, return_nodes, extract_pre_and_post=pre_and_post,
                                     srp_k=srp_k, image_size=image_size, device=device)
        acts, ids = extractor.get_activations(loader, store="host")
        return {name: a.numpy() for name, a in acts.items()}, ids

    if spatial_pool:
        from visreps_tpu_torch.models.pooling import make_pooled_extractor

        layers = list(return_nodes)
        step = make_pooled_extractor(model, layers, pool_size=1, l2_normalize=False)
        feats: dict = {layer: [] for layer in layers}
        ids: list = []
        for x, keys in loader:
            batch = torch.from_numpy(np.ascontiguousarray(x)).to(device, torch.float32)
            out = step(batch.permute(0, 3, 1, 2))
            for layer in layers:
                feats[layer].append(out[layer].cpu().numpy())
            ids.extend(keys)
        return {layer: np.concatenate(v) for layer, v in feats.items()}, ids

    extractor = FeatureExtractor(model, return_nodes, extract_pre_and_post=pre_and_post,
                                 srp_k=1 << 30, image_size=image_size, device=device)
    names = list(dict.fromkeys(extractor.alias[p] for p in extractor.points))
    acts, ids = extractor.extract_layers_exact(loader, names)
    return {name: a.cpu().numpy() for name, a in acts.items()}, ids


if __name__ == "__main__":
    sys.exit(main())
