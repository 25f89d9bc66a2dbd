"""The ('data', 'model') device mesh over the process group's ranks (port
of ``visreps_tpu/parallel/mesh.py``).

A JAX mesh is an array of devices that one program addresses; here it
is a ``torch.distributed.device_mesh.DeviceMesh`` over global ranks, one
process (and one GPU) per rank. ``data_sharding`` and ``replicated`` are
the DTensor placements of the JAX package's ``P("data")`` and ``P()``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

AXES = ("data", "model")


def world_size() -> int:
    """Ranks in the default process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_writer() -> bool:
    """True on the rank that writes results.db, checkpoints and wandb:
    rank 0, or the only process."""
    return rank() == 0


def make_mesh(data: int | None = None, model: int = 1, devices=None) -> DeviceMesh:
    """('data', 'model') mesh over the global ranks ``devices`` (default:
    every rank of the default group), ``data`` × ``model`` of them in
    row-major order. The group must be initialised; the mesh is on CUDA
    under NCCL and on the CPU under gloo."""
    devices = list(range(world_size())) if devices is None else [int(d) for d in devices]
    n = len(devices)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(devices).reshape(data, model),
                      mesh_dim_names=AXES)


def axis_size(mesh: DeviceMesh | None, axis: str = "data") -> int:
    """Ranks along ``axis``; 1 without a mesh."""
    return 1 if mesh is None else mesh.shape[AXES.index(axis)]


def rank_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: its current CUDA device under NCCL, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def data_sharding(mesh: DeviceMesh) -> tuple:
    """Batch-dim sharding over 'data', replicated over 'model'."""
    return (Shard(0), Replicate())


def replicated(mesh: DeviceMesh) -> tuple:
    return (Replicate(), Replicate())


# FC layers big enough to be worth tensor-parallel sharding: CustomCNN's
# and AlexNet's fc1/fc2 hold ~2/3 of all parameters.
_TP_MODULES = ("fc1", "fc2")


def shard_params_tp(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """fc1/fc2 weights column-sharded on 'model' (torch's (out, in) weight
    split along out, the JAX package's (in, out) kernel along its columns),
    their biases with them, every other parameter replicated. Each
    sharded layer's output is all-gathered back to the full width, so the
    module's outputs are the replicated model's. In place; returns
    ``model``."""
    from torch.distributed.tensor.parallel import ColwiseParallel, parallelize_module

    plan = {name: ColwiseParallel(output_layouts=Replicate())
            for name, mod in model.named_modules()
            if isinstance(mod, nn.Linear) and name.split(".")[0] in _TP_MODULES}
    parallelize_module(model, mesh["model"], plan)
    return model
