"""Default mesh for the entry points (port of ``visreps_tpu/parallel/auto.py``).

``python -m visreps_tpu_torch.run`` under ``torchrun`` builds a
('data', 'model') mesh over every rank; one process, or
``--override use_mesh=false``, runs without one, as one card does.
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh

from visreps_tpu_torch.parallel.mesh import make_mesh, world_size


def default_mesh(cfg=None) -> DeviceMesh | None:
    """('data', 'model') mesh over all ranks; None below two ranks or with
    ``cfg.use_mesh`` false. ``cfg.mesh_model_axis`` (default 1: pure data
    parallel) carves out the tensor-parallel axis."""
    if cfg is not None and not cfg.get("use_mesh", True):
        return None
    n = world_size()
    if n < 2:
        return None
    model = int(cfg.get("mesh_model_axis", 1)) if cfg is not None else 1
    if model < 1 or n % model != 0:
        raise ValueError(
            f"mesh_model_axis={model} does not divide {n} devices"
        )
    return make_mesh(data=n // model, model=model)
