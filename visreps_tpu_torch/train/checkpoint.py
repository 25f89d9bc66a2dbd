"""Checkpoints in the JAX package's format (port of
``visreps_tpu/train/checkpoint.py:33-58, 61-72, 97-152``).

Directory ``model_checkpoints/{checkpoint_dir}/cfg{K}{seed_letter}/``
(``K`` = ``pca_n_classes`` with PCA labels, else 200 / 1000; an absolute
``checkpoint_dir`` is used as it is), a ``config.json`` with
``total_params`` and ``trainable_params``, and files
``checkpoint_epoch_{e}.pth`` holding a pickle payload: ``epoch``,
``module_spec`` (class name and constructor fields), ``params`` and
``batch_stats`` as numpy arrays in the Flax layout, ``input_size``,
``metrics`` and ``config``. Weights convert at save and load through
``models/convert.py``, so a checkpoint written by either package loads
in the other. The reference's own checkpoints (a torch zip file holding
the whole pickled module) load through
``models/torch_import.load_reference_checkpoint``.

Mid-training resume (``save_resume_state``, ``resume_from_epoch``): the
optimizer state goes beside the checkpoint as ``resume_epoch_{e}.pt``, a
``torch.save`` of {parameter name: state entries}
(``Optimizer.named_state``). The JAX package opens only
``resume_epoch_{e}.pkl``, so a port-written file never reaches it: its
``load_resume_state`` returns None there and it restarts the optimizer,
as for a missing file. The port reads both: its own file first, else the
JAX package's pickle of an optax state tree, unpickled without optax
(``OPTAX_STATES`` stands in for its state classes) and mapped onto
``torch.optim`` state by parameter name through ``models/convert.py``:
``count`` → ``step``, ``mu`` / ``nu`` → ``exp_avg`` / ``exp_avg_sq``,
``trace`` → ``momentum_buffer``; frozen layers' ``MaskedNode`` leaves are
dropped (the port's optimizer holds no state for them).
"""
from __future__ import annotations

import json
import os
import pickle
from collections import namedtuple
from pathlib import Path
from typing import Mapping

import torch
from torch import nn

from visreps_tpu_torch.core.config import get_seed_letter
from visreps_tpu_torch.device import resolve_device
from visreps_tpu_torch.models.convert import params_from_jax, params_to_jax


def setup_checkpoint_dir(cfg, model: nn.Module) -> tuple[str, dict]:
    """Create the checkpoint directory and its config.json; returns
    (path, the config dict every checkpoint stores)."""
    if cfg.get("pca_labels", False):
        cfg_num = cfg.pca_n_classes
    else:
        cfg_num = 200 if cfg.get("dataset") == "tiny-imagenet" else 1000
    path = os.path.join("model_checkpoints", cfg.checkpoint_dir,
                        f"cfg{cfg_num}{get_seed_letter(cfg.seed)}")
    os.makedirs(path, exist_ok=True)
    n_params = sum(p.numel() for p in model.parameters())
    mask = model.trainable_mask() if hasattr(model, "trainable_mask") else {}
    trainable = sum(p.numel() for name, p in model.named_parameters()
                    if mask.get(name.split(".")[0], True))
    cfg_dict = {"total_params": int(n_params),
                "trainable_params": int(trainable if mask else n_params),
                **(cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg))}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg_dict, f, indent=2)
    return path, cfg_dict


def save_checkpoint(checkpoint_dir: str, epoch: int, model: nn.Module, metrics: dict,
                    cfg_dict: dict, opt_state: Mapping | None = None) -> str:
    """Write ``checkpoint_epoch_{epoch}.pth``; with ``opt_state``
    ({"optimizer": name, "state": ``Optimizer.named_state()``}) also
    ``resume_epoch_{epoch}.pt``. Returns the checkpoint's path."""
    params, batch_stats = params_to_jax(model.state_dict(), getattr(model, "num_heads", None))
    payload = {
        "epoch": epoch,
        "module_spec": model.spec(),
        "params": params,
        "batch_stats": batch_stats,
        "input_size": getattr(model, "INPUT_SIZE", 224),
        "metrics": metrics,
        "config": cfg_dict,
    }
    path = os.path.join(checkpoint_dir, f"checkpoint_epoch_{epoch}.pth")
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    if opt_state is not None:
        state = {name: {k: v.detach().cpu() for k, v in entry.items()}
                 for name, entry in opt_state["state"].items()}
        torch.save({"optimizer": opt_state["optimizer"], "state": state},
                   os.path.join(checkpoint_dir, f"resume_epoch_{epoch}.pt"))
    return path


#: Stand-ins for the optax state classes a JAX resume pickle names
#: (optax 0.2: ``PartitionState`` is ``multi_transform``'s state, formerly
#: ``MultiTransformState``).
OPTAX_STATES = {name: namedtuple(name, fields) for name, fields in {
    "EmptyState": (), "MaskedNode": (), "ScaleByAdamState": ("count", "mu", "nu"),
    "ScaleByScheduleState": ("count",), "TraceState": ("trace",),
    "MaskedState": ("inner_state",), "PartitionState": ("inner_states",),
    "MultiTransformState": ("inner_states",)}.items()}


class _OptaxUnpickler(pickle.Unpickler):
    """Unpickles an optax state tree without optax: its state classes
    become ``OPTAX_STATES``; any other optax name raises."""

    def find_class(self, module: str, name: str):
        if module.split(".")[0] == "optax":
            if name not in OPTAX_STATES:
                raise pickle.UnpicklingError(f"no stand-in for optax class {module}.{name}")
            return OPTAX_STATES[name]
        return super().find_class(module, name)


def _states(tree, cls) -> list:
    """Every ``cls`` node of an unpickled optax tree, in order."""
    if isinstance(tree, cls):
        return [tree]
    if isinstance(tree, Mapping):
        return [s for v in tree.values() for s in _states(v, cls)]
    if isinstance(tree, (tuple, list)):
        return [s for v in tree for s in _states(v, cls)]
    return []


def _unmasked(tree: Mapping) -> dict:
    """The tree without ``MaskedNode`` leaves (and the subtrees they empty)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            v = _unmasked(v)
            if v:
                out[k] = v
        elif not isinstance(v, OPTAX_STATES["MaskedNode"]):
            out[k] = v
    return out


def named_state_from_optax(tree, optimizer: str) -> dict[str, dict[str, torch.Tensor]]:
    """The JAX package's optax state for ``optimizer`` (adamw, adam or sgd)
    → {parameter name: torch.optim state entries}."""
    optimizer = optimizer.lower()
    cls = OPTAX_STATES["TraceState" if optimizer == "sgd" else "ScaleByAdamState"]
    found = _states(tree, cls)
    if len(found) != 1:
        raise ValueError(f"expected one {cls.__name__} in the optax state for {optimizer}, "
                         f"found {len(found)}")
    (st,) = found
    if optimizer == "sgd":
        return {name: {"momentum_buffer": t}
                for name, t in params_from_jax(_unmasked(st.trace)).items()}
    mu, nu = params_from_jax(_unmasked(st.mu)), params_from_jax(_unmasked(st.nu))
    step = torch.tensor(float(st.count), dtype=torch.float32)
    return {name: {"step": step.clone(), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
            for name in mu}


def load_resume_state(checkpoint_dir: str, epoch: int,
                      optimizer: str) -> dict[str, dict[str, torch.Tensor]] | None:
    """The optimizer state saved at ``epoch`` as {parameter name: state
    entries} (CPU tensors): the port's ``resume_epoch_{epoch}.pt``, else
    the JAX package's ``resume_epoch_{epoch}.pkl``, else None. Raises if
    the file holds another optimizer's state than ``optimizer``'s.
    Unpickles the JAX file: load only files from a trusted source."""
    own = os.path.join(checkpoint_dir, f"resume_epoch_{epoch}.pt")
    if os.path.exists(own):
        saved = torch.load(own, map_location="cpu", weights_only=True)
        if saved["optimizer"] != optimizer.lower():
            raise ValueError(f"{own} holds {saved['optimizer']} state, not {optimizer}")
        return saved["state"]
    jax_file = os.path.join(checkpoint_dir, f"resume_epoch_{epoch}.pkl")
    if not os.path.exists(jax_file):
        return None
    with open(jax_file, "rb") as f:
        tree = _OptaxUnpickler(f).load()
    return named_state_from_optax(tree, optimizer)


def build_from_spec(spec: dict) -> nn.Module:
    """The module a ``module_spec`` names, from its constructor fields (a
    ResNet's ``block_cls`` is stored as ``"__class__:Name"``)."""
    from visreps_tpu_torch.models.resnet import ResNet
    from visreps_tpu_torch.models.zoo import MODEL_REGISTRY

    kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in spec.items() if k != "class"}
    ctor = ResNet if spec["class"] == "ResNet" else MODEL_REGISTRY.get(spec["class"])
    if ctor is None:
        raise ValueError(f"Unknown module class in checkpoint: {spec['class']}")
    return ctor(**kwargs)


def load_checkpoint(path: str | Path, device: str | torch.device | None = None):
    """(model in eval mode on ``device``, payload) from a checkpoint file
    written by either package, or from the reference's torch-zip file
    (payload ``{"config": its config}``). Unpickles the file: load only
    checkpoints from a trusted source."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"PK":
        from visreps_tpu_torch.models.torch_import import load_reference_checkpoint

        model, config = load_reference_checkpoint(path, device=device)
        return model, {"config": config}
    with open(path, "rb") as f:
        payload = pickle.load(f)
    model = build_from_spec(payload["module_spec"])
    model.load_state_dict(params_from_jax(payload["params"], payload.get("batch_stats")))
    return model.to(device).eval(), payload
