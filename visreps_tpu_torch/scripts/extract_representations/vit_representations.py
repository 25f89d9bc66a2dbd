"""ViT CLS features of every ImageNet image (port of
``scripts/extract_representations/vit_representations.py``).

``--backend flax`` (named after the JAX script's flax ViT-B) runs the
port's own ViT-B/16 (``models/vit.py``) with IMAGENET1K weights from
``TORCH_WEIGHTS_DIR`` (or, without the file, the seeded init with a
warning) and keeps ``block12``'s CLS token. ``--backend hf`` takes a
HuggingFace ``ViTModel`` from disk only, as the JAX script's
``local_files_only`` does — a snapshot directory, or the hub cache's
snapshot of the ``--model`` id — and keeps ``last_hidden_state[:, 0]``
(the final LayerNorm of the last block's CLS row). The port reads the
snapshot's ``config.json`` and weights without ``transformers``
(``models/hf_vit.read_hf_snapshot``) into its own ViT blocks, which are
HF ViT's: pre-LN attention and exact-GELU MLP.

Usage:
  python -m visreps_tpu_torch.scripts.extract_representations.vit_representations \\
      --backend flax --out features_vit.npz [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from visreps_tpu_torch.device import resolve_device
from visreps_tpu_torch.scripts.extract_representations.utils import extract_and_save

TAP = "block12"


def build_extract(model, device: torch.device):
    """(b, h, w, 3) float32 host batch → (b, 768) CLS token of ``block12``."""
    from visreps_tpu_torch.train.trainer import images_to_device

    @torch.inference_mode()
    def extract(batch):
        return model(images_to_device(batch, device), capture=(TAP,))[1][TAP][:, 0]

    return extract


def vit_from_hf(config: dict, sd: dict):
    """An HF ``ViTModel``'s ``config.json`` dict and state dict (with or
    without the ``vit.`` prefix of ``ViTForImageClassification``) → the
    port's ``ViTBase`` holding its weights, its LayerNorms at the
    config's eps (HF's default 1e-12); the head is left at zeros."""
    from visreps_tpu_torch.models.vit import ViTBase

    sd = {k.removeprefix("vit."): v for k, v in sd.items()}
    layers = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("encoder.layer."))
    conv = sd["embeddings.patch_embeddings.projection.weight"]
    hidden, _, patch, _ = conv.shape
    n_tokens = sd["embeddings.position_embeddings"].shape[1]
    model = ViTBase(num_classes=1, patch_size=patch, hidden_dim=hidden, num_layers=layers,
                    num_heads=config.get("num_attention_heads", 12),
                    mlp_dim=sd["encoder.layer.0.intermediate.dense.weight"].shape[0],
                    image_size=int(round((n_tokens - 1) ** 0.5)) * patch)
    names = {"conv_proj": "embeddings.patch_embeddings.projection",
             "ln": "layernorm"}
    for i in range(layers):
        ours, theirs = f"encoder_layer_{i}", f"encoder.layer.{i}"
        names.update({f"{ours}.ln_1": f"{theirs}.layernorm_before",
                      f"{ours}.ln_2": f"{theirs}.layernorm_after",
                      f"{ours}.self_attention.out": f"{theirs}.attention.output.dense",
                      f"{ours}.mlp_0": f"{theirs}.intermediate.dense",
                      f"{ours}.mlp_3": f"{theirs}.output.dense"})
        for proj in ("query", "key", "value"):
            names[f"{ours}.self_attention.{proj}"] = f"{theirs}.attention.attention.{proj}"
    state = {"cls_token": sd["embeddings.cls_token"],
             "pos_embedding": sd["embeddings.position_embeddings"],
             "head.weight": torch.zeros_like(model.head.weight),
             "head.bias": torch.zeros_like(model.head.bias)}
    for ours, theirs in names.items():
        state[f"{ours}.weight"] = sd[f"{theirs}.weight"]
        state[f"{ours}.bias"] = sd[f"{theirs}.bias"]
    model.load_state_dict({k: v.to(torch.float32) for k, v in state.items()})
    for m in model.modules():
        if isinstance(m, torch.nn.LayerNorm):
            m.eps = config.get("layer_norm_eps", 1e-12)
    return model


def build_extract_hf(model, device: torch.device):
    """(b, h, w, 3) float32 host batch → (b, hidden): the final LayerNorm
    of the last block's CLS row (an HF ViT's ``last_hidden_state[:, 0]``)."""
    from visreps_tpu_torch.train.trainer import images_to_device

    last = f"block{model.num_layers}"

    @torch.inference_mode()
    def extract(batch):
        return model.ln(model(images_to_device(batch, device), capture=(last,))[1][last][:, 0])

    return extract


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="google/vit-large-patch16-224")
    parser.add_argument("--out", default="features_vit.npz")
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--backend", choices=["hf", "flax"], default="hf")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    if args.backend == "hf":
        from visreps_tpu_torch.models.hf_vit import hf_snapshot_dir, read_hf_snapshot

        snap = hf_snapshot_dir(args.model)
        if snap is None:
            raise FileNotFoundError(f"No local HF snapshot of {args.model!r} (a directory, or "
                                    "the hub cache under HF_HUB_CACHE / HF_HOME)")
        model = vit_from_hf(*read_hf_snapshot(snap)).to(device).eval()
        extract = build_extract_hf(model, device)
    else:
        from visreps_tpu_torch.models.torch_import import load_pretrained_torch
        from visreps_tpu_torch.models.zoo import init_model

        model = init_model("ViTBase", 1000, seed=0, device=device)
        extract = build_extract(load_pretrained_torch(model, "ViTBase", 1000), device)
    return extract_and_save(extract, args.out, batch_size=args.batch_size)


if __name__ == "__main__":
    main()
