"""Seeded sparse random projection (port of ``visreps_tpu/ops/srp.py:70-152``).

Every tap is projected D → k = min(4096, D) by a sparse-sign matrix
with P(+v) = P(−v) = density/2, v = √(1/(density·k)), density = 1/√D
(the Achlioptas/Li family that sklearn's SparseRandomProjection draws
from). As in the JAX package the matrix is materialised dense in bf16
and applied as a bf16 matmul with f32 accumulation; it is a pure
function of (D, k, seed), regenerated on the device, never cached on
disk.

The matrices come from a ``torch.Generator`` seeded with the JAX
package's per-dim subseed ``(seed·1_000_003 + D) % (2³¹−1)``: the same
family and the same seeding rule, but not ``jax.random``'s bits (the
reference PyTorch code drew with seed=None, so no canonical matrix
exists). ``models/convert.srp_from_jax`` loads matrices made elsewhere.
Each draw is an ``srp.draw`` span (``core.profiling.span``) counting
the matrix's ``bytes``.
"""
from __future__ import annotations

import math

import torch

from visreps_tpu_torch.core.profiling import span
from visreps_tpu_torch.device import resolve_device

# Rows drawn per generator call: bounds the f32 temporaries of a large
# matrix (AlexNet conv1: D = 193,600) to ~0.5 GB at k = 4096.
_DRAW_ROWS = 16384


def _sparse_sign_rows(gen: torch.Generator, rows: int, k: int, density: float,
                      device) -> torch.Tensor:
    u = torch.rand((rows, k), generator=gen, device=device)
    positive = torch.rand((rows, k), generator=gen, device=device) < 0.5
    value = math.sqrt(1.0 / (density * k))
    sign = torch.where(positive, value, -value)
    return torch.where(u < density, sign, 0.0).to(torch.bfloat16)


class SRPTransform:
    """Seeded sparse-sign JL projection D → k, cached per (D, k) on
    ``device`` (CUDA unless ``"cpu"`` is asked for) for the lifetime of
    the object."""

    def __init__(self, k: int = 4096, seed: int = 0,
                 device: str | torch.device | None = None):
        self.k = k
        self.seed = seed
        self.device = resolve_device(device)
        self._cache: dict = {}

    def out_dim(self, d: int) -> int:
        return min(self.k, d)

    def matrix_chunks(self, d: int) -> tuple:
        """Projection for input dim d as a tuple of bf16 row-chunks.

        Split as the JAX package splits (chunks ≤ 1 GB once the dense
        matrix reaches 2³¹ bytes) so carried-across matrices keep their
        layout; here all chunks are consecutive draws of one generator.
        """
        key = (d, self.k)
        if key not in self._cache:
            k_eff = self.out_dim(d)
            with span("srp.draw", bytes=2 * d * k_eff):
                density = 1.0 / math.sqrt(d)
                subseed = (self.seed * 1_000_003 + d) % (2**31 - 1)
                gen = torch.Generator(device=self.device).manual_seed(subseed)
                if 2 * d * k_eff < 2**31:
                    bounds = [(0, d)]
                else:
                    n_chunks = -(-(2 * d * k_eff) // (2**30))
                    rows = -(-d // n_chunks)
                    bounds = [(s, min(s + rows, d)) for s in range(0, d, rows)]
                chunks = []
                for start, stop in bounds:
                    parts = [_sparse_sign_rows(gen, min(_DRAW_ROWS, stop - r), k_eff,
                                               density, self.device)
                             for r in range(start, stop, _DRAW_ROWS)]
                    chunks.append(torch.cat(parts) if len(parts) > 1 else parts[0])
                self._cache[key] = tuple(chunks)
        return self._cache[key]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Project (..., D) → (..., min(k, D)) with f32 accumulation."""
        return apply_chunked(x, self.matrix_chunks(x.shape[-1]))


def apply_chunked(x: torch.Tensor, chunks) -> torch.Tensor:
    """x (..., D) @ concat(chunks), float32 out, without building the
    concatenated matrix: each row-chunk multiplies its slice of x and
    the partials sum.

    x is rounded to bf16 first, as the JAX package does, and the product
    is the JAX package's on both devices: bf16 operands, f32
    accumulation, f32 output. On CUDA that is one bf16 tensor-core GEMM
    writing f32 (``torch.mm``'s ``out_dtype``). The CPU build has no such
    mm (``aten::mm.dtype`` is CUDA-only), so there the bf16 operands are
    widened to f32, which is exact, and multiplied in f32.
    """
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    out = None
    off = 0
    for m in chunks:
        r = m.shape[0]
        xs = (x[:, off:off + r] if len(chunks) > 1 else x).to(torch.bfloat16)
        if x.is_cuda:
            part = torch.mm(xs, m, out_dtype=torch.float32)
        else:
            part = torch.mm(xs.to(torch.float32), m.to(torch.float32))
        out = part if out is None else out + part
        off += r
    return out.reshape(*lead, out.shape[-1])
