"""Multi-GPU on ``torch.distributed`` (port of ``visreps_tpu/parallel/``).

The JAX package runs one program over a ('data', 'model') device mesh
and lets GSPMD insert the collectives. Torch's idiom is one process per
GPU (``torchrun``; NCCL on CUDA, gloo on the CPU), so here the mesh is a
``DeviceMesh`` over the ranks of the process group and every sharded
routine ends with each rank holding what the single-process run
computes: the all-gathered RDM, extraction rows and bootstrap scores, and
the row-sharded encoding eval's results (``shard.RowBlocks``).
Only rank 0 writes results.db, checkpoints and wandb (``is_writer``).
"""
from visreps_tpu_torch.parallel.auto import default_mesh
from visreps_tpu_torch.parallel.feed import local_batch_size, process_slice, put_global_batch
from visreps_tpu_torch.parallel.mesh import (
    data_sharding,
    is_writer,
    make_mesh,
    replicated,
    shard_params_tp,
)
from visreps_tpu_torch.parallel.shard import extract_sharded_batch, rdm_sharded

__all__ = [
    "default_mesh",
    "make_mesh",
    "data_sharding",
    "replicated",
    "shard_params_tp",
    "rdm_sharded",
    "extract_sharded_batch",
    "put_global_batch",
    "process_slice",
    "local_batch_size",
    "is_writer",
]
