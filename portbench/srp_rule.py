"""The seeding rule of the sparse random projection, frozen for the
reference: a copy of ``visreps_tpu_torch/ops/srp.py``'s
``_sparse_sign_rows`` and ``SRPTransform.matrix_chunks``.

A tap of width D is projected to k = min(k, D) by a sparse-sign matrix,
P(+v) = P(−v) = density / 2 with density = 1 / √D and v = √(1 / (density
· k)), drawn from ``torch.Generator(device).manual_seed((seed ·
1_000_003 + D) mod (2³¹ − 1))`` in draws of at most 16,384 rows, the rows
cut into chunks of at most 1 GiB once the bf16 matrix reaches 2³¹ bytes.
The draw sizes are part of the rule: the same generator drawn in other
sizes gives other numbers.
"""
from __future__ import annotations

import math

import torch

DRAW_ROWS = 16384


def _sparse_sign_rows(gen: torch.Generator, rows: int, k: int, density: float,
                      device) -> torch.Tensor:
    u = torch.rand((rows, k), generator=gen, device=device)
    positive = torch.rand((rows, k), generator=gen, device=device) < 0.5
    value = math.sqrt(1.0 / (density * k))
    sign = torch.where(positive, value, -value)
    return torch.where(u < density, sign, 0.0).to(torch.bfloat16)


def out_dim(d: int, k: int) -> int:
    return min(k, d)


def matrix_chunks(d: int, k: int, seed: int, device) -> list[torch.Tensor]:
    """The (D, min(k, D)) bf16 projection of width ``d`` as row chunks."""
    k_eff = out_dim(d, k)
    density = 1.0 / math.sqrt(d)
    subseed = (seed * 1_000_003 + d) % (2**31 - 1)
    gen = torch.Generator(device=device).manual_seed(subseed)
    if 2 * d * k_eff < 2**31:
        bounds = [(0, d)]
    else:
        n_chunks = -(-(2 * d * k_eff) // (2**30))
        rows = -(-d // n_chunks)
        bounds = [(s, min(s + rows, d)) for s in range(0, d, rows)]
    chunks = []
    for start, stop in bounds:
        parts = [_sparse_sign_rows(gen, min(DRAW_ROWS, stop - r), k_eff, density, device)
                 for r in range(start, stop, DRAW_ROWS)]
        chunks.append(torch.cat(parts) if len(parts) > 1 else parts[0])
    return chunks


def project(x: torch.Tensor, chunks) -> torch.Tensor:
    """(B, D) f32 activations → (B, k) f32: x rounded to bf16, each row
    chunk's product accumulated in f32 (on the card the bf16 tensor-core
    GEMM with f32 output; on the CPU the bf16 values widened to f32, which
    is exact), the chunks' partials summed in order."""
    out = None
    off = 0
    for m in chunks:
        xs = x[:, off:off + m.shape[0]].to(torch.bfloat16)
        off += m.shape[0]
        if xs.is_cuda:
            part = torch.mm(xs, m, out_dtype=torch.float32)
        else:
            part = torch.mm(xs.to(torch.float32), m.to(torch.float32))
        out = part if out is None else out + part
    return out
