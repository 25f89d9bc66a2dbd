"""Images at the poles of each principal component (port of
``experiments/pca_analysis/pca_poles_images.py``).

The source-model feature matrix is z-scored with the fit rows' mean and
ddof-0 std (floored at 1e-8), the covariance ``zᵀz / (n − 1)`` of at most
110,000 fit rows (numpy ``RandomState(42).choice``, so the same rows as
the JAX program) is taken apart by ``torch.linalg.eigh`` on the device
(f32, TF32 off), and every row is projected onto the top 6 eigenvectors
(in chunks, each row's product unchanged). The n_poles lowest and
highest scores per PC go to a CSV of (pc, pole, score, image_file,
image_class_id, image_class); the rows, the CSV and the class names
(``map_clsloc.txt`` under ``$IMAGENET_DATA_DIR``) stay on the host.
No eigenvector sign is chosen: a PC negated by the solver swaps its
poles, as it would in the JAX program.

Usage:
  python -m visreps_tpu_torch.experiments.pca_analysis.pca_poles_images \\
      --features_filename features_alexnet.npz [--dataset imagenet] [--n_poles 100] \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import csv
import os
import time

import numpy as np
import torch

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.device import resolve_device

PROJECT_CHUNK = 65536  # rows per projection product (1.28 M × 4,096 f32 rows are 21 GB)


def load_imagenet_class_mapping(imagenet_data_dir: str) -> dict:
    """wnid → class name from ``map_clsloc.txt``."""
    mapping = {}
    with open(os.path.join(imagenet_data_dir, "map_clsloc.txt")) as f:
        for line in f:
            parts = line.strip().split(" ", 1)
            if len(parts) >= 2:
                mapping[parts[0]] = parts[1]
    rprint(f"Loaded {len(mapping)} class mappings", style="info")
    return mapping


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def fit_pcs(features: np.ndarray, n_components: int = 6, n_fit: int = 110000,
            seed: int = 42, device=None) -> dict:
    """The fit: the fit rows' mean and floored ddof-0 std and the top
    ``n_components`` eigenvalues and eigenvectors (columns, largest first)
    of their z-scored covariance, as f32 tensors on the device, with the
    fit rows' count and the seconds of each step (fit_rows: gather, copy
    and z-score; gram; eigh)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    n_fit = min(n_fit, features.shape[0])
    fit_idx = rng.choice(features.shape[0], n_fit, replace=False)

    t0 = time.perf_counter()
    x_fit = torch.from_numpy(np.ascontiguousarray(features[fit_idx], np.float32)).to(dev)
    mean = x_fit.mean(dim=0)
    std = x_fit.std(dim=0, correction=0).clamp_min(1e-8)
    zf = (x_fit - mean) / std
    del x_fit
    _sync(dev)
    t1 = time.perf_counter()
    cov = zf.T @ zf / (zf.shape[0] - 1)
    del zf
    _sync(dev)
    t2 = time.perf_counter()
    vals, vecs = torch.linalg.eigh(cov)
    top = vecs.flip(1)[:, :n_components].contiguous()
    _sync(dev)
    t3 = time.perf_counter()
    return {"mean": mean, "std": std, "eigenvalues": vals.flip(0)[:n_components],
            "eigenvectors": top, "n_fit": n_fit,
            "seconds": {"fit_rows": t1 - t0, "gram": t2 - t1, "eigh": t3 - t2}}


def compute_pc_scores(features: np.ndarray, n_components: int = 6, n_fit: int = 110000,
                      seed: int = 42, device=None) -> np.ndarray:
    """(rows, n_components) f32 scores of every row on the fit's top PCs."""
    fit = fit_pcs(features, n_components, n_fit, seed, device)
    mean, std, top = fit["mean"], fit["std"], fit["eigenvectors"]
    out = np.empty((features.shape[0], n_components), np.float32)
    for i in range(0, features.shape[0], PROJECT_CHUNK):
        x = torch.from_numpy(np.ascontiguousarray(features[i:i + PROJECT_CHUNK], np.float32))
        out[i:i + PROJECT_CHUNK] = (((x.to(top.device) - mean) / std) @ top).cpu().numpy()
    return out


def analyze_pc_poles(pc_scores: np.ndarray, image_names, class_mapping: dict,
                     n_poles: int = 100) -> list:
    """Rows for the lowest and highest ``n_poles`` images of each PC."""
    rows = []
    for pc_idx in range(pc_scores.shape[1]):
        order = np.argsort(pc_scores[:, pc_idx])
        for indices, pole in ((order[:n_poles], "low"), (order[-n_poles:][::-1], "high")):
            for idx in indices:
                name = image_names[idx]
                class_id = name.split("_")[0]
                rows.append({
                    "pc": pc_idx + 1, "pole": pole,
                    "score": float(pc_scores[idx, pc_idx]),
                    "image_file": name, "image_class_id": class_id,
                    "image_class": class_mapping.get(class_id, "unknown"),
                })
    return rows


def write_csv(rows, path):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    rprint(f"Saved results to {path}", style="success")


def main(argv=None):
    from visreps_tpu_torch.core.env import get_env_var

    parser = argparse.ArgumentParser()
    parser.add_argument("--features_filename", required=True)
    parser.add_argument("--dataset", default="imagenet")
    parser.add_argument("--n_poles", type=int, default=100)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    class_mapping = load_imagenet_class_mapping(get_env_var("IMAGENET_DATA_DIR"))
    path = os.path.join("datasets", "obj_cls", args.dataset, args.features_filename)
    data = np.load(path, allow_pickle=True)
    features = data["fc2"] if "fc2" in data else data["clip_features"]
    features = features.reshape(features.shape[0], -1)
    names = [os.path.basename(str(n)) for n in data["image_names"]]

    scores = compute_pc_scores(features, device=device)
    rows = analyze_pc_poles(scores, names, class_mapping, args.n_poles)
    suffix = args.features_filename.replace("features_", "").replace(".npz", "")
    out = os.path.join("datasets", "obj_cls", args.dataset, "pca_poles",
                       f"pca_poles_{suffix}.csv")
    write_csv(rows, out)
    return out


if __name__ == "__main__":
    main()
