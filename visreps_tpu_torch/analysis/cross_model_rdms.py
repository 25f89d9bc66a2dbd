"""Cross-model RDM comparison matrices (port of
``visreps_tpu/analysis/cross_model_rdms.py``).

All-layer RDMs for a list of models over one stimulus set, and the
layer × layer RDM-correlation matrix for every model pair. Extraction
runs through the port's FeatureExtractor (uint8 transfer, SRP on the
device) for every family: the torchvision-architecture models and the
CLIP / DINOv2 towers (``models/hf_vit.py``). Every layer RDM is one
``compute_rdm`` call: the hand-written RDM kernel on CUDA.

Usage:
  python -m visreps_tpu_torch.analysis.cross_model_rdms \\
      --models AlexNet clip-vit-l14 dinov2-l14 --stimuli <dir>|synthetic:64 \\
      --out cross_model_rdms.npz [--srp-k 4096] [--method spearman]
      [--random-init] [--image-size 224] [--tiny-towers] [--device cpu]

Output npz (the JAX package's keys):
  layers__<model>        layer-name array per model
  rdm__<model>__<layer>  (optional, --save-rdms) the (N, N) RDMs
  corr__<mi>__<mj>       (L_i, L_j) RDM-correlation matrix per pair
  summary                best (model_i, model_j, layer_i, layer_j, corr) rows per pair
  method, model_errors   (the latter only when a model failed)

``run`` records a failing model in ``model_errors`` and goes on with the
others, as the JAX package does; ``main`` then exits 1.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
import traceback
from typing import Dict, List

import numpy as np
import torch

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.device import resolve_device
from visreps_tpu_torch.models.extractor import FeatureExtractor
from visreps_tpu_torch.ops.rdm import compute_rdm, compute_rdm_correlation_batched

#: Seconds each model of the last ``run`` took, from its load to its RDMs.
LAST_MODEL_TIMES: Dict[str, float] = {}

TINY_TOWER = {"hidden": 32, "num_layers": 2, "heads": 4, "mlp_dim": 64, "patch": 16}


def _tower_nodes(model) -> List[str]:
    return (["patch_embed"] + [f"block{i}" for i in range(1, model.num_layers + 1)]
            + ["pooled"])


def resolve_model(name: str, pretrained: bool, image_size: int, tiny_towers: bool = False,
                  device: str | torch.device | None = None):
    """Model name → (model on ``device`` in eval mode, return_nodes)."""
    lname = name.lower()
    if "clip" in lname or "dino" in lname:
        from visreps_tpu_torch.models.hf_vit import CLIPVisionTower, DINOv2Tower, load_tower

        if tiny_towers:
            kwargs = dict(TINY_TOWER, image_size=image_size)
            if "clip" in lname:
                model = CLIPVisionTower(**kwargs, projection_dim=None)
            else:
                model = DINOv2Tower(**kwargs)
            model.init_weights(torch.Generator().manual_seed(0))
            model = model.to(resolve_device(device)).eval()
        else:
            model = load_tower(name, pretrained=pretrained, image_size=image_size, device=device)
        return model, _tower_nodes(model)

    from visreps_tpu_torch.models.zoo import TORCHVISION_RETURN_NODES, init_model

    model = init_model(name, 1000, seed=0, device=device)
    if pretrained:
        from visreps_tpu_torch.models.torch_import import load_pretrained_torch

        model = load_pretrained_torch(model, name, 1000)
    nodes = TORCHVISION_RETURN_NODES.get(name, [p for p in ("conv1", "fc1") if p in model.TAPS])
    return model, nodes


def build_stimuli(spec: str, image_size: int) -> Dict[str, object]:
    """'synthetic:N' (uint8 noise images from numpy's PCG64(0)) or a
    directory of images → {id: array or path}."""
    if spec.startswith("synthetic:"):
        n = int(spec.split(":", 1)[1])
        rng = np.random.Generator(np.random.PCG64(0))
        return {f"syn{i:04d}": rng.integers(0, 256, (image_size, image_size, 3), dtype=np.uint8)
                for i in range(n)}
    return {f: os.path.join(spec, f) for f in sorted(os.listdir(spec))}


def model_layer_rdms(model, return_nodes, loader, srp_k: int, image_size: int,
                     device: str | torch.device | None = None) -> Dict[str, torch.Tensor]:
    """{layer: (N, N) float32 RDM on ``device``} over the loader's
    stimuli, rows in sorted-id order; each from the layer's f32 SRP
    activations."""
    device = resolve_device(device)
    ex = FeatureExtractor(model, return_nodes, extract_pre_and_post=False, srp_k=srp_k,
                          image_size=image_size, device=device)
    acts, ids = ex.get_activations(loader, store="host")
    order = torch.as_tensor(np.argsort(np.asarray(ids, dtype=object)))
    rdms = {layer: compute_rdm(a[order].to(device)) for layer, a in acts.items()}
    ex.free_projection_cache()
    return rdms


def cross_model_matrix(rdms_a: Dict[str, torch.Tensor], rdms_b: Dict[str, torch.Tensor],
                       method: str = "spearman") -> np.ndarray:
    """(L_a, L_b) RDM-correlation matrix, all pairs in one batched call on
    the RDMs' device."""
    la, lb = list(rdms_a), list(rdms_b)
    pairs_a = torch.stack([rdms_a[x] for x in la for _ in lb])
    pairs_b = torch.stack([rdms_b[y] for _ in la for y in lb])
    vals = compute_rdm_correlation_batched(pairs_a, pairs_b, method)
    return vals.cpu().numpy().reshape(len(la), len(lb))


def run(models: List[str], stimuli_spec: str, out: str, srp_k: int = 4096,
        batch_size: int = 64, image_size: int = 224, method: str = "spearman",
        pretrained: bool = True, save_rdms: bool = False, tiny_towers: bool = False,
        device: str | torch.device | None = None) -> dict:
    """Every model's layer RDMs and every pair's matrix, saved to ``out``;
    returns the npz payload."""
    from visreps_tpu_torch.data.loader import make_stimuli_loader
    from visreps_tpu_torch.data.transforms import get_transform

    device = resolve_device(device)
    stimuli = build_stimuli(stimuli_spec, image_size)
    rprint(f"  {len(stimuli)} stimuli, {len(models)} models", style="info")

    all_rdms: Dict[str, Dict[str, torch.Tensor]] = {}
    errors: Dict[str, str] = {}
    LAST_MODEL_TIMES.clear()
    for name in models:
        # One model failing must not lose the others' matrices: record
        # the error and go on (main exits 1 on any).
        t0 = time.perf_counter()
        try:
            model, nodes = resolve_model(name, pretrained, image_size, tiny_towers, device)
            transform = get_transform("imgnet", image_size=image_size, normalize=False)
            loader = make_stimuli_loader(stimuli, transform, batch_size, 4)
            all_rdms[name] = model_layer_rdms(model, nodes, loader, srp_k, image_size, device)
            del model
        except Exception as e:
            errors[name] = f"{type(e).__name__}: {e}"[:300]
            traceback.print_exc()
            rprint(f"  [{name}] FAILED: {errors[name]}", style="warning")
            continue
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        LAST_MODEL_TIMES[name] = time.perf_counter() - t0
        rprint(f"  [{name}] {len(all_rdms[name])} layer RDMs", style="success")

    payload: dict = {}
    summary = []
    names = list(all_rdms)
    for i, mi in enumerate(names):
        payload[f"layers__{mi}"] = np.asarray(list(all_rdms[mi]), dtype=object)
        if save_rdms:
            for layer, rdm in all_rdms[mi].items():
                payload[f"rdm__{mi}__{layer}"] = rdm.cpu().numpy().astype(np.float32)
        for mj in names[i:]:
            mat = cross_model_matrix(all_rdms[mi], all_rdms[mj], method)
            payload[f"corr__{mi}__{mj}"] = mat
            m = mat.copy()
            if mi == mj:  # the self-pair's diagonal is trivially 1
                np.fill_diagonal(m, -np.inf)
            bi, bj = np.unravel_index(np.argmax(m), m.shape)
            summary.append((mi, mj, list(all_rdms[mi])[bi], list(all_rdms[mj])[bj],
                            float(mat[bi, bj])))
            rprint(f"  {mi} vs {mj}: best {summary[-1][2]} ↔ {summary[-1][3]} "
                   f"({method} {summary[-1][4]:.4f})", style="highlight")
    payload["summary"] = np.asarray(summary, dtype=object)
    payload["method"] = method
    if errors:
        payload["model_errors"] = np.asarray([f"{k}: {v}" for k, v in errors.items()],
                                             dtype=object)
    np.savez(out, **payload)
    rprint(f"  Saved {out}", style="success")
    return payload


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--models", nargs="+", required=True)
    p.add_argument("--stimuli", default="synthetic:64")
    p.add_argument("--out", default="cross_model_rdms.npz")
    p.add_argument("--srp-k", type=int, default=4096)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--method", default="spearman", choices=["spearman", "pearson", "kendall"])
    p.add_argument("--random-init", action="store_true", help="skip pretrained weight loading")
    p.add_argument("--save-rdms", action="store_true")
    p.add_argument("--tiny-towers", action="store_true",
                   help="2-layer towers for offline smoke runs")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    payload = run(a.models, a.stimuli, a.out, srp_k=a.srp_k, batch_size=a.batch_size,
                  image_size=a.image_size, method=a.method, pretrained=not a.random_init,
                  save_rdms=a.save_rdms, tiny_towers=a.tiny_towers, device=a.device)
    if "model_errors" in payload:
        rprint(f"  {len(payload['model_errors'])} model(s) failed", style="warning")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
