"""Binary-PC-code RSA against NSD neural data (port of
``experiments/binary_pc_rsa/main.py``).

AlexNet's fc2 activations of each subject's shared test stimuli are
projected onto the top-n eigenvectors, each PC split at its median
(numpy's median: for an even count the mean of the two middle scores)
into a bit, and the (optionally rank-weighted) Hamming RDM of the codes
correlated with the subject's Pearson neural RDM. The Hamming RDM is one
product, Σ_k w_k·xor(b_ik, b_jk) = s_i + s_j − 2·(bW)bᵀ with s = bW·1,
over Σw: plain torch, not the RDM kernel. With 0/1 codes and integer
weights every term is an integer below 2²⁴, so the f32 result equals a
brute-force XOR sum bit for bit. The neural RDMs go through
``ops/rdm.compute_rdm`` (the Hopper kernel on the card), one per
(subject, region): they do not depend on the number of PCs. As in the
JAX package, activations align with the TEST (shared-stimuli) split.

Usage:
  python -m visreps_tpu_torch.experiments.binary_pc_rsa.main --eigenvectors eig.npz \\
      --subjects 0 1 --n-pcs 2 4 8 --out binary_pc_rsa.csv [--device cpu]
"""
from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np
import torch

from visreps_tpu_torch.core.config import Config
from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.device import input_device, resolve_device
from visreps_tpu_torch.ops.rdm import compute_rdm, compute_rdm_correlation

REGIONS = ["early visual stream", "ventral visual stream"]


def hamming_rdm_weighted(codes: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Rank-weighted Hamming dissimilarity of binary codes (n, bits), as
    rank-1 + rank-1 − 2·Gram over Σw, on the codes' device."""
    b = codes.to(torch.float32)
    w = weights.to(b.device, torch.float32)
    s = b @ w  # (n,)
    gram = (b * w[None, :]) @ b.T
    d = s[:, None] + s[None, :] - 2.0 * gram
    return d / w.sum()


def median_rows(scores: torch.Tensor) -> torch.Tensor:
    """``np.median(scores, axis=0)``: the middle score, or for an even
    count the mean of the two middle ones, in the scores' dtype."""
    ordered = torch.sort(scores, dim=0).values
    h = scores.shape[0] // 2
    if scores.shape[0] % 2:
        return ordered[h]
    return (ordered[h - 1] + ordered[h]) / 2


def project_and_binarize(acts, eigenvectors, mean, n_pcs: int, device=None) -> torch.Tensor:
    """(n, n_pcs) int32 codes: PC scores above each PC's median. The
    product runs in the inputs' numpy result type (f32, or f64 if any is
    f64), on ``device`` (default: where ``acts`` lies)."""
    device = input_device(acts, device)
    dtype = getattr(torch, np.result_type(
        *(np.dtype(str(x.dtype).removeprefix("torch.")) for x in (acts, eigenvectors, mean))).name)
    a = torch.as_tensor(acts).to(device, dtype)
    v = torch.as_tensor(eigenvectors).to(device, dtype)[:, :n_pcs]
    scores = (a - torch.as_tensor(mean).to(device, dtype)) @ v
    return (scores > median_rows(scores)).to(torch.int32)


def binary_rdm(codes: torch.Tensor, weighted: bool) -> torch.Tensor:
    n_bits = codes.shape[1]
    w = (torch.arange(n_bits, 0, -1, dtype=torch.float32) if weighted
         else torch.ones(n_bits, dtype=torch.float32))
    return hamming_rdm_weighted(codes, w.to(codes.device))


def subject_activations(extractor, layer: str, subject_idx: int, batch_size: int,
                        num_workers: int):
    """(exact ``layer`` taps on the extractor's device, ids) of one
    subject's shared test stimuli."""
    from visreps_tpu_torch.data.loader import make_stimuli_loader
    from visreps_tpu_torch.data.neural import load_nsd_data
    from visreps_tpu_torch.data.transforms import get_transform

    cfg = Config({"neural_dataset": "nsd", "region": REGIONS[0], "subject_idx": subject_idx})
    targets0, stimuli = load_nsd_data(cfg)
    test = stimuli.subset([sid for sid in targets0["test"] if sid in stimuli])
    dl = make_stimuli_loader(test, get_transform("imgnet"), batch_size, num_workers)
    acts, ids = extractor.extract_layers_exact(dl, [layer])
    return acts[layer], ids


def run_analysis(args) -> list[dict]:
    from visreps_tpu_torch.data.neural import load_nsd_data
    from visreps_tpu_torch.models.extractor import FeatureExtractor
    from visreps_tpu_torch.models.zoo import init_model

    device = resolve_device(args.device)
    eig = np.load(args.eigenvectors)
    eigenvectors, mean = eig["eigenvectors"], eig["mean"]

    model = init_model(args.model, 1000, seed=0, device=device)
    if args.pretrained == "imagenet1k":
        from visreps_tpu_torch.models.torch_import import load_pretrained_torch

        model = load_pretrained_torch(model, args.model, 1000)
    extractor = FeatureExtractor(model, [args.layer], extract_pre_and_post=False,
                                 srp_k=10 ** 9, image_size=224, device=device)

    results = []
    for subject_idx in args.subjects:
        acts, ids = subject_activations(extractor, args.layer, subject_idx, args.batch_size,
                                        args.num_workers)
        aligned = {}
        for region in REGIONS:
            cfg2 = Config({"neural_dataset": "nsd", "region": region,
                           "subject_idx": subject_idx})
            targets, _ = load_nsd_data(cfg2)
            test = targets["test"]
            keep = [i for i, sid in enumerate(ids) if str(sid) in test]
            neural = np.stack([np.asarray(test[str(ids[i])], np.float32) for i in keep])
            aligned[region] = (
                acts[torch.as_tensor(keep, dtype=torch.long, device=acts.device)],
                compute_rdm(torch.as_tensor(neural, device=device), correlation="pearson"),
            )

        for n_pcs in args.n_pcs:
            for region in REGIONS:
                a_acts, neural_rdm = aligned[region]
                codes = project_and_binarize(a_acts, eigenvectors, mean, n_pcs)
                for weighted in (True, False):
                    b_rdm = binary_rdm(codes, weighted)
                    for corr in args.correlations:
                        score = compute_rdm_correlation(b_rdm, neural_rdm, correlation=corr)
                        results.append({
                            "subject_idx": subject_idx, "n_pcs": n_pcs,
                            "region": region, "weighted": weighted,
                            "correlation": corr, "score": score,
                        })
                        rprint(
                            f"  subj {subject_idx} {region} n_pcs={n_pcs} "
                            f"weighted={weighted} {corr}: {score:.4f}",
                            style="info",
                        )
    return results


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--eigenvectors", required=True,
                        help=".npz with 'eigenvectors' (d, k) and 'mean' (d,)")
    parser.add_argument("--model", default="AlexNet")
    parser.add_argument("--pretrained", default="imagenet1k",
                        choices=["imagenet1k", "none"])
    parser.add_argument("--layer", default="fc2")
    parser.add_argument("--subjects", type=int, nargs="+", default=list(range(8)))
    parser.add_argument("--n-pcs", type=int, nargs="+", default=list(range(2, 21)))
    parser.add_argument("--correlations", nargs="+",
                        default=["spearman", "kendall"])
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--num-workers", type=int, default=8)
    parser.add_argument("--out", default="experiments/binary_pc_rsa/binary_pc_rsa.csv")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    results = run_analysis(args)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(results[0].keys()))
        writer.writeheader()
        writer.writerows(results)
    rprint(f"Saved {len(results)} rows to {args.out}", style="success")
    return results


if __name__ == "__main__":
    main()
