"""Carry weights and projections across from and to the JAX package.

The functions take and return numpy arrays only, so the port never
imports JAX: the caller turns JAX pytrees into numpy (``np.asarray``)
first. Names map one to one, the Flax path joined with dots: a leaf
``{path}/kernel`` becomes ``{path}.weight`` (a conv's HWIO → OIHW, a dense
layer's (in, out) → (out, in)), ``scale`` becomes ``weight`` and ``bias``
stays ``bias``; the ``batch_stats`` leaves ``mean`` / ``var`` become the
BatchNorm buffers ``running_mean`` / ``running_var``. AlexNet's flat tree
(``conv1/kernel``) and CustomCNN's nested one (``conv1/conv/kernel``,
``conv1/bn/scale``) go through the same rule, as do BatchNorm, GroupNorm
and LayerNorm scales. Flax's attention kernels are 3-D: query/key/value
(hidden, heads, head_dim) become a Linear's (heads·head_dim, hidden), out
(heads, head_dim, hidden) becomes (hidden, heads·head_dim), and their
(heads, head_dim) biases are flattened. Parameters owned directly keep
their names: ECTiedNet's depthwise ``dw_weight`` (3, 3, 1, C) → (C, 1, 3, 3),
``dw_bias``, ``gamma``, ViT's ``cls_token`` and ``pos_embedding``, and the
CLIP / DINOv2 towers' ``class_embedding``, ``cls_token`` (1, 1, H), 2-D
``pos_embedding`` and LayerScales ``ls1`` / ``ls2``; the towers' attention
is four 2-D dense layers ``q`` / ``k`` / ``v`` / ``out``, carried as any
dense layer is.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from visreps_tpu_torch.ops.srp import SRPTransform

_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}
_KEPT = ("dw_bias", "gamma", "cls_token", "pos_embedding", "class_embedding", "ls1", "ls2")
_ATTENTION = ("query", "key", "value", "out")


def _leaves(tree: Mapping, prefix: tuple = ()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _tensor(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))  # a writable copy


def params_from_jax(params: Mapping, batch_stats: Mapping | None = None) -> dict[str, torch.Tensor]:
    """Flax ``params`` (and ``batch_stats``) trees → PyTorch state_dict.

    A BatchNorm carried across also gets ``num_batches_tracked`` = 0
    (the JAX package keeps no such count; momentum makes it unused).
    """
    state = {}
    for path, leaf in _leaves(params):
        *mod, name = path
        arr = np.asarray(leaf)
        if name in ("kernel", "dw_weight"):
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 3 and mod and mod[-1] == "out":
                arr = arr.reshape(-1, arr.shape[-1]).T
            elif arr.ndim == 3:
                arr = arr.reshape(arr.shape[0], -1).T
            else:
                raise ValueError(f"{'/'.join(path)} has unsupported rank {arr.ndim}")
            name = "weight" if name == "kernel" else name
        elif name == "scale":
            name = "weight"
        elif name == "bias":
            arr = arr.reshape(-1)  # attention biases are (heads, head_dim)
        elif name not in _KEPT:
            raise ValueError(f"unknown parameter {'/'.join(path)}")
        state[".".join([*mod, name])] = _tensor(arr)
    for path, leaf in _leaves(batch_stats or {}):
        *mod, name = path
        if name not in _STAT_NAMES:
            raise ValueError(f"unknown batch statistic {'/'.join(path)}")
        state[".".join([*mod, _STAT_NAMES[name]])] = _tensor(leaf)
        state[".".join([*mod, "num_batches_tracked"])] = torch.tensor(0)
    return state


def params_to_jax(state: Mapping[str, torch.Tensor],
                  num_heads: int | None = None) -> tuple[dict, dict | None]:
    """PyTorch state_dict → (Flax ``params``, ``batch_stats`` or None) as
    nested dicts of float32 numpy arrays, the inverse of
    ``params_from_jax``. ``num_heads`` splits the projections of a
    ``self_attention`` module back into Flax's 3-D kernels.
    ``num_batches_tracked`` is dropped."""
    params: dict = {}
    stats: dict = {}

    def put(tree, mod, name, arr):
        node = tree
        for key in mod:
            node = node.setdefault(key, {})
        node[name] = arr

    for key, t in state.items():
        *mod, name = key.split(".")
        if name == "num_batches_tracked":
            continue
        arr = t.detach().to("cpu", torch.float32).numpy()
        attention = len(mod) >= 2 and mod[-2] == "self_attention" and mod[-1] in _ATTENTION
        if attention and num_heads is None:
            raise ValueError(f"{key}: pass num_heads to split attention projections")
        if name in ("running_mean", "running_var"):
            put(stats, mod, name.removeprefix("running_"), arr.copy())
        elif attention and name == "weight":
            if mod[-1] == "out":  # (hidden, heads·hd) → (heads, hd, hidden)
                put(params, mod, "kernel", np.ascontiguousarray(arr.T).reshape(num_heads, -1,
                                                                               arr.shape[0]))
            else:  # (heads·hd, hidden) → (hidden, heads, hd)
                put(params, mod, "kernel", np.ascontiguousarray(arr.T).reshape(arr.shape[1],
                                                                               num_heads, -1))
        elif attention and name == "bias" and mod[-1] != "out":
            put(params, mod, "bias", arr.reshape(num_heads, -1))
        elif name == "dw_weight":
            put(params, mod, name, np.ascontiguousarray(arr.transpose(2, 3, 1, 0)))
        elif name in _KEPT:
            put(params, mod, name, arr.copy())
        elif name == "weight":
            if arr.ndim == 4:
                put(params, mod, "kernel", np.ascontiguousarray(arr.transpose(2, 3, 1, 0)))
            elif arr.ndim == 2:
                put(params, mod, "kernel", np.ascontiguousarray(arr.T))
            else:
                put(params, mod, "scale", arr.copy())
        elif name == "bias":
            put(params, mod, "bias", arr.copy())
        else:
            raise ValueError(f"unknown state entry {key}")
    return params, (stats or None)


def flax_ndim(name: str, tensor: torch.Tensor) -> int:
    """The rank the state entry ``name`` has in the Flax layout: the
    tensor's own, except the query/key/value biases of a
    ``self_attention`` module, which Flax keeps as (heads, head_dim)."""
    *mod, leaf = name.split(".")
    split_bias = (leaf == "bias" and len(mod) >= 2 and mod[-2] == "self_attention"
                  and mod[-1] in _ATTENTION and mod[-1] != "out")
    return 2 if split_bias else tensor.dim()


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
