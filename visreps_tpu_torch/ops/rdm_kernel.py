"""Binding of the hand-written Hopper RDM kernel (``csrc/rdm.cu``).

``rdm_from_centered(xc, std, correction)`` computes, for centred rows
``xc`` (n, d) and their standard deviations ``std`` (n,),

    out[i, j] = 1 − clip((xc_i·xc_j / d) / (std_i·std_j + correction), −1, 1)

with a zero diagonal — ``compute_rdm``'s Gram and epilogue in one call.
On a CUDA tensor it launches the kernel (TMA-fed ``wgmma``: bf16
operands directly, f32 operands as three TF32 products; f32
accumulation) on the current stream, or raises; on a CPU tensor it runs
the plain version, ``rdm_from_centered_reference``. There is no other
path.

The launch plan — 128 × 128 tiles of the upper triangle only, the
number of splits of d that fills the card's SMs (its own count, read per
device), the split bounds, the grid and the workspace — is computed here
(``plan``) and handed to the C entry point, as is the padding of rows to
a 16-byte stride (``pad_rows``) that the TMA descriptor needs.

The kernel is compiled from the package's own source with ``nvcc`` at
first use into ``visreps_tpu_torch/_build/`` (a plain C interface loaded
with ctypes; no PyTorch or CUTLASS headers, so the build takes seconds).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
from dataclasses import dataclass
from fractions import Fraction
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "rdm.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

TILE = 128          # output tile edge, rows of one TMA box (rdm.cu TILE)
STAGE_BYTES = 128   # bytes of d per row in one pipeline stage (rdm.cu ROW_BYTES)
PART_DEPTH = 512    # least span of d per split (rdm.cu PART_DEPTH)
MAX_SPLITS = 16     # rdm.cu MAX_SPLITS

#: RDMs computed by the kernel since import (or since a caller reset it
#: to 0): one per ``rdm_from_centered`` call on a CUDA tensor, although a
#: call that splits d makes two CUDA launches (Gram, then reduce).
LAUNCHES = 0
#: nvcc's diagnostics (ptxas register / shared-memory report) of the
#: build this process made, or "" when the library was already built.
BUILD_LOG = ""

_LIB = None


@dataclass(frozen=True)
class Plan:
    """Launch plan of one RDM: block (t, s) computes upper tile
    ``upper_tiles(tiles_per_side)[t]`` over stages
    [stage_bounds[s], stage_bounds[s + 1]) of d."""
    n: int
    d: int
    sms: int                         # SMs the plan fills
    stage: int                       # elements of d per stage
    tiles_per_side: int
    splits: int
    stage_bounds: tuple[int, ...]    # splits + 1 stage indices

    @property
    def tiles(self) -> int:
        return self.tiles_per_side * (self.tiles_per_side + 1) // 2

    @property
    def n_pad(self) -> int:
        return self.tiles_per_side * TILE

    @property
    def grid(self) -> tuple[int, int]:
        return self.tiles, self.splits

    @property
    def split_bounds(self) -> tuple[int, ...]:
        """The splits' bounds in elements of d: [0, ..., d]."""
        return tuple(min(k * self.stage, self.d) for k in self.stage_bounds)

    @property
    def workspace(self) -> tuple[int, int, int] | None:
        """Shape of the f32 partial-Gram workspace, or None for one split."""
        return (self.splits, self.n_pad, self.n_pad) if self.splits > 1 else None


@functools.lru_cache(maxsize=None)
def plan(n: int, d: int, element_size: int, sms: int) -> Plan:
    """Tiles and splits for (n, d) rows of ``element_size`` bytes on a
    card with ``sms`` SMs (``device_sms``; 132 on an H100 SXM).

    d is split only where the upper tiles do not reach one wave of ``sms``
    blocks; then the number of splits s minimises the waves per unit of
    work, ceil(tiles·s / sms) / s (the smallest such s), with each split
    at least PART_DEPTH of d. Split bounds are whole stages, the last
    ends at d.
    """
    stage = STAGE_BYTES // element_size
    per_side = math.ceil(n / TILE)
    tiles = per_side * (per_side + 1) // 2
    stages = math.ceil(d / stage)
    splits = 1
    if tiles < sms:
        most = max(1, min(MAX_SPLITS, d // PART_DEPTH))
        splits = min(range(1, most + 1),
                     key=lambda s: (Fraction(math.ceil(tiles * s / sms), s), s))
    full = d // stage
    bounds = tuple(j * full // splits for j in range(splits)) + (stages,)
    return Plan(n, d, sms, stage, per_side, splits, bounds)


@functools.lru_cache(maxsize=None)
def device_sms(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def upper_tiles(per_side: int) -> list[tuple[int, int]]:
    """(tile_row, tile_col), tile_row <= tile_col, in block order: the
    triangle row by row, as the kernel maps blockIdx.x."""
    return [(r, c) for r in range(per_side) for c in range(r, per_side)]


def pad_rows(xc: torch.Tensor) -> torch.Tensor:
    """``xc`` itself when its rows start 16-byte aligned and are a
    multiple of 16 bytes long (TMA's rule), else a copy whose rows are
    ``ld`` elements apart, ``ld`` the next such length. Columns d..ld are
    left unset: the tensor map spans only d columns (dims[0] = d), so TMA
    never reads them and fills what lies past d with zeros itself."""
    n, d = xc.shape
    align = 16 // xc.element_size()
    if d % align == 0 and xc.data_ptr() % 16 == 0:
        return xc
    ld = -(-d // align) * align
    out = torch.empty((n, ld), dtype=xc.dtype, device=xc.device)
    out[:, :d] = xc
    return out


def build() -> Path:
    """Compile ``csrc/rdm.cu`` for sm_90a unless this source (and these
    flags) are built already; returns the shared library's path."""
    global BUILD_LOG
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"librdm_{digest.hexdigest()[:12]}.so"
    if so.exists():
        return so
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found (needs the CUDA toolkit on PATH "
                           "or under /usr/local/cuda)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, so)
    BUILD_LOG = proc.stderr
    return so


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        for fn in (lib.rdm_f32, lib.rdm_bf16):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


#: Columns of d per product of the CPU Gram (the kernel's PART_DEPTH).
CPU_GRAM_DEPTH = 512


def _gram(x: torch.Tensor) -> torch.Tensor:
    """x·xᵀ in f32. On the CPU the product accumulates CPU_GRAM_DEPTH
    columns at a time, in order: MKL's one-thread sgemm sums a small
    Gram's long rows in one running sum (at (12, 139,968) 4e-5 of the
    diagonal off an f64 Gram, 2e-6 with 8 threads), so a single product
    made the RDM, and the ranks of its near-tied entries, follow
    torch's thread count. Blocked, the Gram is the same to the bit on 1
    to 8 threads and within 6e-7 of f64 there."""
    if x.device.type != "cpu":
        return x @ x.T
    g = torch.zeros((x.shape[0], x.shape[0]), dtype=torch.float32)
    for block in x.split(CPU_GRAM_DEPTH, dim=1):
        g.addmm_(block, block.T)
    return g


def rdm_from_centered_reference(xc: torch.Tensor, std: torch.Tensor,
                                correction: float = 1e-12) -> torch.Tensor:
    """Plain torch version of the kernel, in compute_rdm's f32
    arithmetic (an f32 Gram, so exact ±1 correlations clamp to the same
    tied 0 / 2 dissimilarities as in the JAX package)."""
    x = xc.to(torch.float32)
    cov = _gram(x) / x.shape[1]
    corr = (cov / (std[:, None] * std[None, :] + correction)).clamp(-1.0, 1.0)
    corr.fill_diagonal_(1.0)
    return 1.0 - corr


def rdm_from_centered(xc: torch.Tensor, std: torch.Tensor,
                      correction: float = 1e-12) -> torch.Tensor:
    """(n, d) centred rows + (n,) stds → (n, n) float32 RDM.

    CUDA tensors go through the kernel; CPU tensors through the plain
    version. Raises on any other device, dtype, shape or layout.
    ``LAUNCHES`` rises by one per call on the card: one RDM, although a
    call that splits d makes two CUDA launches (Gram, then reduce).
    """
    global LAUNCHES
    if xc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rdm_from_centered: unsupported device {xc.device}")
    if xc.dim() != 2 or xc.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"xc must be 2-D float32/bfloat16, got {tuple(xc.shape)} {xc.dtype}")
    n, d = xc.shape
    if std.shape != (n,) or std.dtype != torch.float32 or std.device != xc.device:
        raise ValueError(f"std must be ({n},) float32 on {xc.device}")
    if not (xc.is_contiguous() and std.is_contiguous()):
        raise ValueError("xc and std must be contiguous")
    if n == 0 or d == 0:
        raise ValueError(f"empty input ({n}, {d})")
    if xc.device.type == "cpu":
        return rdm_from_centered_reference(xc, std, correction)
    lib = _lib()
    x = pad_rows(xc)
    p = plan(n, d, x.element_size(), device_sms(xc.device.index))
    out = torch.empty((n, n), dtype=torch.float32, device=xc.device)
    ws = (torch.empty(p.workspace, dtype=torch.float32, device=xc.device)
          if p.workspace else None)
    bounds = (ctypes.c_int * len(p.stage_bounds))(*p.stage_bounds)
    fn = lib.rdm_f32 if xc.dtype == torch.float32 else lib.rdm_bf16
    stream = torch.cuda.current_stream(xc.device).cuda_stream
    with torch.cuda.device(xc.device):
        err = fn(x.data_ptr(), std.data_ptr(), out.data_ptr(),
                 None if ws is None else ws.data_ptr(), n, d, x.shape[1], correction,
                 p.splits, bounds, stream)
    if err != 0:
        raise RuntimeError(f"rdm kernel launch failed (code {err}: a cudaError_t, or "
                           f"-1 no driver entry point, -2 tensor map refused, -3 bad "
                           f"plan) at shape ({n}, {d}) {xc.dtype}, {p.splits} splits")
    LAUNCHES += 1
    return out
