"""ImageNet-C robustness of representations via linear probes (port of
``experiments/coarse_grain_benefits/imagenet_c_robustness.py``).

(1) Exact features of one tap for N images per model, (2) a logistic
probe fit on a train split, (3) the test images corrupted by each of
the 15 corruptions at one severity (``corruptions.py``, on the device)
and the probe's accuracy on them; clean and corrupted accuracy and their
ratio per (model, corruption) go to a CSV.

The probe is the JAX module's sklearn pipeline (``StandardScaler``, then
``LogisticRegression``: lbfgs, L2, C = 1, intercept, multinomial),
written as a small torch function (no sklearn here): standardise the
features, then minimise the mean multinomial log-loss plus
½‖W‖² / (C·n) (sklearn's objective divided by n; the intercept is not
penalised) by L-BFGS in float64 on the features' device.

Usage:
  python -m visreps_tpu_torch.experiments.coarse_grain_benefits.imagenet_c_robustness \\
      --checkpoints "64way=ckpt_a.pth" "1000way=ckpt_b.pth" \\
      --probe-dataset /path/tiny-imagenet/train --n-images 2000 [--device cpu]
"""
from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.device import input_device, resolve_device
from visreps_tpu_torch.experiments.coarse_grain_benefits.corruptions import (
    CORRUPTIONS,
    corrupt_batch,
)

SEED = 42


class _ImageBatches:
    """The extractor's loader interface over an in-memory (N, H, W, 3)
    uint8 array: ``dataset`` and batches of (images, ids)."""

    def __init__(self, images: np.ndarray, batch_size: int):
        self.dataset = images
        self.batch_size = batch_size

    def __iter__(self):
        for i in range(0, len(self.dataset), self.batch_size):
            batch = self.dataset[i:i + self.batch_size]
            yield batch, [str(j) for j in range(i, i + len(batch))]


def extract_features(extractor, layer: str, images_u8: np.ndarray,
                     batch_size: int) -> torch.Tensor:
    """(N, D) float32 exact features of ``layer`` on the extractor's
    device; uint8 images are normalised there."""
    acts, _ = extractor.extract_layers_exact(_ImageBatches(images_u8, batch_size), [layer])
    return acts[layer]


class LogisticProbe:
    """A fitted standardiser and multinomial logistic regression over
    ``classes`` (the sorted train labels, as sklearn's ``classes_``)."""

    def __init__(self, mean, scale, coef, intercept, classes):
        self.mean, self.scale = mean, scale
        self.coef, self.intercept = coef, intercept  # (classes, d), (classes,)
        self.classes = classes

    def decision_function(self, x) -> torch.Tensor:
        z = (torch.as_tensor(x).to(self.coef.device, torch.float64) - self.mean) / self.scale
        return z @ self.coef.T + self.intercept

    def predict(self, x) -> torch.Tensor:
        return self.classes[self.decision_function(x).argmax(dim=1)]

    def score(self, x, labels) -> float:
        """Mean accuracy, as sklearn's ``score``."""
        y = torch.as_tensor(np.asarray(labels), device=self.coef.device)
        return float((self.predict(x) == y).to(torch.float64).mean())


def fit_probe(train_feats, train_labels, C: float = 1.0, max_iter: int = 1000,
              tol: float = 1e-10, device=None) -> LogisticProbe:
    """``StandardScaler`` + multinomial ``LogisticRegression(C)`` by
    L-BFGS (strong Wolfe line search, 10 corrections, as scipy's) in
    float64; stops at max |gradient| ≤ ``tol``, a loss change below
    1e-14 or ``max_iter`` iterations."""
    device = input_device(train_feats, device)
    x = torch.as_tensor(train_feats).to(device, torch.float64)
    n = x.shape[0]
    mean = x.mean(dim=0)
    var = x.var(dim=0, unbiased=False)
    # sklearn's _is_constant_feature: a variance within roundoff of 0 scales by 1
    eps = torch.finfo(torch.float64).eps
    constant = var <= n * eps * var + (n * mean * eps) ** 2
    scale = torch.where(constant, 1.0, torch.sqrt(var))
    z = (x - mean) / scale
    classes, inverse = np.unique(np.asarray(train_labels), return_inverse=True)
    if len(classes) < 2:
        raise ValueError("the probe needs at least two classes")
    y = torch.as_tensor(inverse.reshape(-1), device=device)
    coef = torch.zeros((len(classes), x.shape[1]), dtype=torch.float64, device=device,
                       requires_grad=True)
    intercept = torch.zeros(len(classes), dtype=torch.float64, device=device,
                            requires_grad=True)
    opt = torch.optim.LBFGS([coef, intercept], lr=1.0, max_iter=max_iter, tolerance_grad=tol,
                            tolerance_change=1e-14, history_size=10,
                            line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        loss = (F.cross_entropy(z @ coef.T + intercept, y)
                + 0.5 * (coef * coef).sum() / (C * n))
        loss.backward()
        return loss

    opt.step(closure)
    return LogisticProbe(mean, scale, coef.detach(), intercept.detach(),
                         torch.as_tensor(classes, device=device))


def load_images(probe_dataset: str, n_images: int, image_size: int):
    """Raw uint8 images + labels from an ImageFolder-style directory."""
    from PIL import Image

    root = Path(probe_dataset)
    classes = sorted(p.name for p in root.iterdir() if p.is_dir())
    images, labels = [], []
    per_class = max(1, n_images // max(len(classes), 1))
    for ci, cname in enumerate(classes):
        files = sorted((root / cname).rglob("*"))
        files = [f for f in files if f.suffix.lower() in (".jpeg", ".jpg", ".png")]
        for f in files[:per_class]:
            img = Image.open(f).convert("RGB").resize((image_size, image_size))
            images.append(np.asarray(img, np.uint8))
            labels.append(ci)
    return np.stack(images), np.asarray(labels)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoints", nargs="+", required=True,
                        help="name=checkpoint_path pairs (framework .pth)")
    parser.add_argument("--probe-dataset", required=True,
                        help="ImageFolder directory for probe images")
    parser.add_argument("--layer", default="fc2_post")
    parser.add_argument("--n-images", type=int, default=5000)
    parser.add_argument("--severity", type=int, default=3)
    parser.add_argument("--train-fraction", type=float, default=0.6)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--corruptions", nargs="+", default=list(CORRUPTIONS))
    parser.add_argument("--out", default="experiments/coarse_grain_benefits/results/"
                                         "imagenet_c_robustness.csv")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from visreps_tpu_torch.models.extractor import FeatureExtractor
    from visreps_tpu_torch.train.checkpoint import load_checkpoint

    device = resolve_device(args.device)
    images, labels = load_images(args.probe_dataset, args.n_images, args.image_size)
    rng = np.random.RandomState(SEED)
    perm = rng.permutation(len(images))
    split = int(args.train_fraction * len(images))
    tr_idx, te_idx = perm[:split], perm[split:]
    rprint(f"{len(images)} images: {len(tr_idx)} train / {len(te_idx)} test", style="info")

    trained = {}
    results = []
    for spec in args.checkpoints:
        name, _, path = spec.partition("=")
        model, _ = load_checkpoint(path, device=device)
        layer_base = args.layer.replace("_pre", "").replace("_post", "")
        ex = FeatureExtractor(model, [layer_base], image_size=args.image_size, device=device)
        train_feats = extract_features(ex, args.layer, images[tr_idx], args.batch_size)
        test_feats = extract_features(ex, args.layer, images[te_idx], args.batch_size)
        probe = fit_probe(train_feats, labels[tr_idx])
        clean_acc = probe.score(test_feats, labels[te_idx])
        rprint(f"  {name}: clean acc {clean_acc*100:.2f}%", style="highlight")
        trained[name] = (ex, probe, clean_acc)

    for corruption in args.corruptions:
        corrupted = corrupt_batch(corruption, images[te_idx], severity=args.severity,
                                  seed=SEED, device=device).to(torch.uint8).cpu().numpy()
        for name, (ex, probe, clean_acc) in trained.items():
            feats = extract_features(ex, args.layer, corrupted, args.batch_size)
            acc = probe.score(feats, labels[te_idx])
            rel = acc / clean_acc if clean_acc > 0 else 0.0
            rprint(f"  {corruption:<18} {name}: {acc*100:.2f}% (rel {rel:.3f})", style="info")
            results.append({
                "model_name": name, "layer": args.layer,
                "corruption": corruption, "severity": args.severity,
                "clean_acc": clean_acc, "corrupt_acc": acc,
                "relative_robustness": rel,
            })

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(results[0].keys()))
        writer.writeheader()
        writer.writerows(results)
    rprint(f"Saved {len(results)} rows -> {args.out}", style="success")
    return results


if __name__ == "__main__":
    main()
