"""Per-rank pieces of a global batch (port of
``visreps_tpu/parallel/feed.py``).

Each rank reads the same, deterministically ordered global batch and
keeps its contiguous piece (``process_slice``); ``put_global_batch``
moves that piece to the rank's device as a DTensor whose global view is
the whole batch, the counterpart of ``jax.make_array_from_process_local_data``.
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from visreps_tpu_torch.parallel.mesh import data_sharding, rank, rank_device, world_size


def process_slice(n: int, process_id: int | None = None,
                  n_processes: int | None = None) -> slice:
    """This rank's contiguous index range of a length-n global axis; the
    remainder goes to the last rank, so the concatenation over ranks is
    the single-process order."""
    pid = rank() if process_id is None else process_id
    nproc = world_size() if n_processes is None else n_processes
    per = n // nproc
    start = pid * per
    stop = n if pid == nproc - 1 else start + per
    return slice(start, stop)


def local_batch_size(global_batch_size: int, mesh: DeviceMesh | None) -> int:
    """Per-rank batch size for a global batch size, which must divide
    evenly over the ranks."""
    nproc = world_size()
    if global_batch_size % nproc:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by "
            f"{nproc} processes")
    return global_batch_size // nproc


def put_global_batch(x, mesh: DeviceMesh, placements=None) -> DTensor:
    """This rank's piece ``x`` of the global batch (``process_slice`` of
    it, every piece the same size) on the rank's device, as a DTensor
    sharded over 'data' whose ``full_tensor()`` is the global batch."""
    local = torch.as_tensor(x).to(rank_device(mesh))
    return DTensor.from_local(local, mesh, placements or data_sharding(mesh), run_check=False)
