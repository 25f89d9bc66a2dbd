"""Carry weights and projections across from the JAX package.

Both functions take numpy arrays only, so the port never imports JAX:
the caller turns the JAX pytrees into numpy (``np.asarray``) first.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from visreps_tpu_torch.ops.srp import SRPTransform


def params_from_jax(params: Mapping[str, Mapping[str, np.ndarray]]) -> dict[str, torch.Tensor]:
    """Flax parameter tree → PyTorch state_dict.

    ``{name}/kernel`` of a conv is HWIO and becomes OIHW; of a dense
    layer it is (in, out) and becomes (out, in). Biases carry over as
    they are. Names are kept (``conv1.weight``, ``fc3.bias`` …), which
    are the port's AlexNet parameter names.
    """
    state = {}
    for name, leaf in params.items():
        kernel = np.asarray(leaf["kernel"], np.float32)
        if kernel.ndim == 4:
            weight = kernel.transpose(3, 2, 0, 1)
        elif kernel.ndim == 2:
            weight = kernel.T
        else:
            raise ValueError(f"{name}/kernel has unsupported rank {kernel.ndim}")
        state[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(weight))
        state[f"{name}.bias"] = torch.from_numpy(np.asarray(leaf["bias"], np.float32).copy())
    return state


def srp_from_jax(srp: SRPTransform, chunks_by_dim: Mapping[int, tuple]) -> None:
    """Load projection matrices into ``srp``'s cache, replacing what it
    would draw itself: ``{D: (chunk, ...)}`` with each chunk a float
    array of bf16-representable values (the JAX bf16 matrix widened to
    float32), stored back as bf16 on the transform's device."""
    for d, chunks in chunks_by_dim.items():
        tensors = tuple(
            torch.from_numpy(np.asarray(c, np.float32)).to(srp.device, torch.bfloat16)
            for c in chunks)
        if sum(t.shape[0] for t in tensors) != d or any(
                t.shape[1] != srp.out_dim(d) for t in tensors):
            raise ValueError(f"SRP chunks for D={d} do not form a ({d}, {srp.out_dim(d)}) matrix")
        srp._cache[(int(d), srp.k)] = tensors
