"""Binding of the hand-written Hopper RDM kernel (``csrc/rdm.cu``).

``rdm_from_centered(xc, std, correction)`` computes, for centred rows
``xc`` (n, d) and their standard deviations ``std`` (n,),

    out[i, j] = 1 − clip((xc_i·xc_j / d) / (std_i·std_j + correction), −1, 1)

with a zero diagonal — ``compute_rdm``'s Gram and epilogue in one pass.
On a CUDA tensor it launches the kernel (f32 or bf16 operands, f32
accumulation) on the current stream, or raises; on a CPU tensor it runs
the plain version, ``rdm_from_centered_reference``. There is no other
path.

The kernel is compiled from the package's own source with ``nvcc`` at
first use into ``visreps_tpu_torch/_build/`` (a plain C interface loaded
with ctypes; no PyTorch headers, so the build takes seconds).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "rdm.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Kernel launches since import (or since a caller reset it to 0).
#: Incremented only where the CUDA kernel is launched.
LAUNCHES = 0
#: nvcc's diagnostics (ptxas register / shared-memory report) of the
#: build this process made, or "" when the library was already built.
BUILD_LOG = ""

_LIB = None


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
        args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        for fn in (lib.rdm_f32, lib.rdm_bf16):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def rdm_from_centered_reference(xc: torch.Tensor, std: torch.Tensor,
                                correction: float = 1e-12) -> torch.Tensor:
    """Plain torch version of the kernel, in compute_rdm's f32
    arithmetic (an f32 Gram, so exact ±1 correlations clamp to the same
    tied 0 / 2 dissimilarities as in the JAX package)."""
    x = xc.to(torch.float32)
    cov = (x @ x.T) / x.shape[1]
    corr = (cov / (std[:, None] * std[None, :] + correction)).clamp(-1.0, 1.0)
    corr.fill_diagonal_(1.0)
    return 1.0 - corr


def rdm_from_centered(xc: torch.Tensor, std: torch.Tensor,
                      correction: float = 1e-12) -> torch.Tensor:
    """(n, d) centred rows + (n,) stds → (n, n) float32 RDM.

    CUDA tensors go through the kernel; CPU tensors through the plain
    version. Raises on any other device, dtype, shape or layout.
    """
    global LAUNCHES
    if xc.device.type == "cpu":
        return rdm_from_centered_reference(xc, std, correction)
    if xc.device.type != "cuda":
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
    lib = _lib()
    out = torch.empty((n, n), dtype=torch.float32, device=xc.device)
    fn = lib.rdm_f32 if xc.dtype == torch.float32 else lib.rdm_bf16
    stream = torch.cuda.current_stream(xc.device).cuda_stream
    with torch.cuda.device(xc.device):
        err = fn(xc.data_ptr(), std.data_ptr(), out.data_ptr(), n, d,
                 correction, stream)
    if err != 0:
        raise RuntimeError(f"rdm kernel launch failed (cudaError {err}) at "
                           f"shape ({n}, {d}) {xc.dtype}")
    LAUNCHES += 1
    return out
