"""torchvision weights and the reference's whole-module checkpoints
(port of ``visreps_tpu/models/torch_import.py``).

The per-family converters are the JAX package's own, in numpy: a torch
state dict in torchvision's (or the reference CustomCNN's) key layout
becomes the Flax-layout tree of the JAX package (conv OIHW → HWIO, linear
(O, I) → (I, O), BatchNorm weight/bias → scale/bias plus running stats,
ViT's packed in_proj split into query/key/value), and
``models/convert.params_from_jax`` turns that tree into the port's
state dict. Going through the same tree keeps the two packages' imports
equal by construction. A classifier head whose row count differs from
the model's keeps its fresh init.

torchvision weight FILES are read from ``$TORCH_WEIGHTS_DIR`` or
``~/.cache/torch/hub/checkpoints``; nothing is downloaded. A missing
file leaves the random init in place with a warning, as in the JAX
package, so both give the same results for the same inputs.
"""
from __future__ import annotations

import os
import sys
import types
from pathlib import Path

import numpy as np
import torch
from torch import nn

from visreps_tpu_torch.core.logging import rprint
from visreps_tpu_torch.core.profiling import span
from visreps_tpu_torch.device import resolve_device
from visreps_tpu_torch.models.convert import params_from_jax

# torchvision release filenames for IMAGENET1K weights
_WEIGHT_FILES = {
    "AlexNet": "alexnet-owt-7be5be79.pth",
    "VGG16": "vgg16-397923af.pth",
    "ResNet18": "resnet18-f37072fd.pth",
    "ResNet50": "resnet50-11ad3fa6.pth",  # IMAGENET1K_V2
    "ViTBase": "vit_b_16-c867db91.pth",
}


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def _conv(w) -> np.ndarray:
    return np.transpose(_np(w), (2, 3, 1, 0))


def _lin(w) -> np.ndarray:
    return np.transpose(_np(w), (1, 0))


def _set(tree: dict, path: tuple, value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _bn(params, stats, flax_path, sd, torch_prefix):
    _set(params, flax_path + ("scale",), _np(sd[f"{torch_prefix}.weight"]))
    _set(params, flax_path + ("bias",), _np(sd[f"{torch_prefix}.bias"]))
    _set(stats, flax_path + ("mean",), _np(sd[f"{torch_prefix}.running_mean"]))
    _set(stats, flax_path + ("var",), _np(sd[f"{torch_prefix}.running_var"]))


def _conv_layer(params, flax_path, sd, torch_prefix, bias=True):
    _set(params, flax_path + ("kernel",), _conv(sd[f"{torch_prefix}.weight"]))
    if bias and f"{torch_prefix}.bias" in sd:
        _set(params, flax_path + ("bias",), _np(sd[f"{torch_prefix}.bias"]))


def _lin_layer(params, flax_path, sd, torch_prefix):
    _set(params, flax_path + ("kernel",), _lin(sd[f"{torch_prefix}.weight"]))
    if f"{torch_prefix}.bias" in sd:
        _set(params, flax_path + ("bias",), _np(sd[f"{torch_prefix}.bias"]))


# ── per-family state-dict → Flax-layout tree converters ──────────────


def convert_alexnet(sd, num_classes=1000):
    params, stats = {}, {}
    for i, idx in enumerate([0, 3, 6, 8, 10], start=1):
        _conv_layer(params, (f"conv{i}",), sd, f"features.{idx}")
    for i, idx in zip((1, 2, 3), (1, 4, 6)):
        if i == 3 and _np(sd[f"classifier.{idx}.weight"]).shape[0] != num_classes:
            continue  # head replaced: keep the fresh init
        _lin_layer(params, (f"fc{i}",), sd, f"classifier.{idx}")
    return params, stats


def convert_vgg16(sd, num_classes=1000):
    params, stats = {}, {}
    conv_idx = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    for i, idx in enumerate(conv_idx, start=1):
        _conv_layer(params, (f"conv{i}",), sd, f"features.{idx}")
    for i, idx in zip((1, 2, 3), (0, 3, 6)):
        if i == 3 and _np(sd[f"classifier.{idx}.weight"]).shape[0] != num_classes:
            continue
        _lin_layer(params, (f"fc{i}",), sd, f"classifier.{idx}")
    return params, stats


def convert_resnet(sd, stage_sizes, num_classes=1000):
    params, stats = {}, {}
    _conv_layer(params, ("conv1",), sd, "conv1", bias=False)
    _bn(params, stats, ("bn1",), sd, "bn1")
    for stage, n in enumerate(stage_sizes, start=1):
        for b in range(n):
            t, f = f"layer{stage}.{b}", f"layer{stage}_{b}"
            for conv_name in ("conv1", "conv2", "conv3"):
                if f"{t}.{conv_name}.weight" in sd:
                    bn_name = conv_name.replace("conv", "bn")
                    _conv_layer(params, (f, conv_name), sd, f"{t}.{conv_name}", bias=False)
                    _bn(params, stats, (f, bn_name), sd, f"{t}.{bn_name}")
            if f"{t}.downsample.0.weight" in sd:
                _conv_layer(params, (f, "downsample_conv"), sd, f"{t}.downsample.0", bias=False)
                _bn(params, stats, (f, "downsample_bn"), sd, f"{t}.downsample.1")
    if _np(sd["fc.weight"]).shape[0] == num_classes:
        _lin_layer(params, ("fc",), sd, "fc")
    return params, stats


def convert_vit(sd, num_classes=1000, num_layers=12, hidden=768, heads=12):
    params, stats = {}, {}
    _conv_layer(params, ("conv_proj",), sd, "conv_proj")
    _set(params, ("cls_token",), _np(sd["class_token"]))
    _set(params, ("pos_embedding",), _np(sd["encoder.pos_embedding"]))
    hd = hidden // heads
    for i in range(num_layers):
        t, f = f"encoder.layers.encoder_layer_{i}", f"encoder_layer_{i}"
        for ln in ("ln_1", "ln_2"):
            _set(params, (f, ln, "scale"), _np(sd[f"{t}.{ln}.weight"]))
            _set(params, (f, ln, "bias"), _np(sd[f"{t}.{ln}.bias"]))
        w_in = _np(sd[f"{t}.self_attention.in_proj_weight"])  # (3h, h)
        b_in = _np(sd[f"{t}.self_attention.in_proj_bias"])
        for j, name in enumerate(("query", "key", "value")):
            w = w_in[j * hidden:(j + 1) * hidden].T.reshape(hidden, heads, hd)
            b = b_in[j * hidden:(j + 1) * hidden].reshape(heads, hd)
            _set(params, (f, "self_attention", name, "kernel"), w)
            _set(params, (f, "self_attention", name, "bias"), b)
        w_out = _lin(sd[f"{t}.self_attention.out_proj.weight"]).reshape(heads, hd, hidden)
        _set(params, (f, "self_attention", "out", "kernel"), w_out)
        _set(params, (f, "self_attention", "out", "bias"),
             _np(sd[f"{t}.self_attention.out_proj.bias"]))
        for flax_name, torch_name in (("mlp_0", "mlp.0"), ("mlp_3", "mlp.3")):
            _lin_layer(params, (f, flax_name), sd, f"{t}.{torch_name}")
    _set(params, ("ln", "scale"), _np(sd["encoder.ln.weight"]))
    _set(params, ("ln", "bias"), _np(sd["encoder.ln.bias"]))
    if _np(sd["heads.head.weight"]).shape[0] == num_classes:
        _lin_layer(params, ("head",), sd, "heads.head")
    return params, stats


def convert_custom_cnn(sd, num_classes=1000):
    """Reference CustomCNN/TinyCustomCNN state dict → Flax-layout tree:
    the convolutions (each followed by its BatchNorm) and linears (each
    but the head followed by a BatchNorm1d) found by scanning the keys."""
    params, stats = {}, {}
    conv_indices = sorted(
        {int(k.split(".")[1]) for k in sd if k.startswith("features.") and k.endswith(".weight")
         and sd[k].ndim == 4})
    for i, idx in enumerate(conv_indices, start=1):
        _conv_layer(params, (f"conv{i}", "conv"), sd, f"features.{idx}", bias=False)
        _bn(params, stats, (f"conv{i}", "bn"), sd, f"features.{idx + 1}")
    lin_indices = sorted(
        {int(k.split(".")[1]) for k in sd if k.startswith("classifier.") and k.endswith(".weight")
         and sd[k].ndim == 2})
    for i, idx in enumerate(lin_indices[:-1], start=1):
        _lin_layer(params, (f"fc{i}", "fc"), sd, f"classifier.{idx}")
        _bn(params, stats, (f"fc{i}", "bn"), sd, f"classifier.{idx + 1}")
    head_idx = lin_indices[-1]
    if _np(sd[f"classifier.{head_idx}.weight"]).shape[0] == num_classes:
        _lin_layer(params, ("fc3",), sd, f"classifier.{head_idx}")
    return params, stats


# (state dict, class count, the model) → tree; ResNet and ViT read their
# structure from the model (the JAX package's defaults at full size).
_CONVERTERS = {
    "AlexNet": lambda sd, n, m: convert_alexnet(sd, n),
    "VGG16": lambda sd, n, m: convert_vgg16(sd, n),
    "ResNet18": lambda sd, n, m: convert_resnet(sd, m.stage_sizes, n),
    "ResNet50": lambda sd, n, m: convert_resnet(sd, m.stage_sizes, n),
    "ViTBase": lambda sd, n, m: convert_vit(sd, n, m.num_layers, m.hidden_dim, m.num_heads),
    "CustomCNN": lambda sd, n, m: convert_custom_cnn(sd, n),
    "TinyCustomCNN": lambda sd, n, m: convert_custom_cnn(sd, n),
}


@torch.no_grad()
def apply_torch_state_dict(model: nn.Module, model_name: str, sd: dict,
                           num_classes: int | None = None) -> nn.Module:
    """Overlay a torch state dict in ``model_name``'s layout onto ``model``
    (in place; returned). Entries the converter leaves out keep the
    model's values; a shape that differs raises ValueError."""
    if model_name not in _CONVERTERS:
        raise ValueError(f"No torch converter for {model_name}")
    params, stats = _CONVERTERS[model_name](sd, num_classes or 1000, model)
    imported = params_from_jax(params, stats)
    state = model.state_dict()
    for key, value in imported.items():
        if key not in state or key.endswith("num_batches_tracked"):
            continue
        if value.shape != state[key].shape:
            raise ValueError(f"Shape mismatch at {key}: imported {tuple(value.shape)} "
                             f"vs model {tuple(state[key].shape)}")
        state[key].copy_(value)
    return model


def find_torch_weight_file(model_name: str) -> Path | None:
    fname = _WEIGHT_FILES.get(model_name)
    if fname is None:
        return None
    for root in (os.environ.get("TORCH_WEIGHTS_DIR", ""),
                 os.path.expanduser("~/.cache/torch/hub/checkpoints")):
        if root and (Path(root) / fname).exists():
            return Path(root) / fname
    return None


def load_pretrained_torch(model: nn.Module, model_name: str,
                          num_classes: int | None = None) -> nn.Module:
    """Import IMAGENET1K torchvision weights into ``model`` if the file is
    on disk (the ``torch_import.load`` span); otherwise warn and keep its
    random init."""
    path = find_torch_weight_file(model_name)
    if path is None:
        rprint(f"Pretrained weights for {model_name} not found locally "
               "(set TORCH_WEIGHTS_DIR); using random init.", style="warning")
        return model
    with span("torch_import.load"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        rprint(f"  Imported torchvision weights: {path.name}", style="success")
        return apply_torch_state_dict(model, model_name, sd, num_classes)


# The reference's module paths (including the legacy custom_cnn alias)
# and the classes a pickled reference model may name.
_REFERENCE_MODULES = ("visreps.models.custom_model", "visreps.models.custom_cnn",
                      "visreps.models.standard_model", "visreps.models.ecnet")
_REFERENCE_CLASSES = ("CustomCNN", "TinyCustomCNN", "BaseCNN", "ECTiedNet", "ECBlock",
                      "DivisiveNorm", "BlurPool2d")


def _register_reference_stubs() -> None:
    """Stub ``nn.Module`` classes under the reference's module paths, so
    its pickled modules unpickle without the reference installed; modules
    already present are left as they are."""
    for qualname in _REFERENCE_MODULES:
        mod = types.ModuleType(qualname)
        for cname in _REFERENCE_CLASSES:
            mod.__dict__[cname] = type(cname, (nn.Module,), {})
        sys.modules.setdefault(qualname, mod)
        parts = qualname.split(".")
        for i in range(1, len(parts)):
            parent = ".".join(parts[:i])
            sys.modules.setdefault(parent, types.ModuleType(parent))


def load_reference_checkpoint(path: str | Path, num_classes: int | None = None,
                              model_name: str = "CustomCNN",
                              device: str | torch.device | None = None):
    """A reference visreps checkpoint (a whole pickled nn.Module, or a
    dict holding it under ``model``) → (model in eval mode on ``device``,
    the checkpoint's ``config`` or None). The class count comes from the
    last 2-D weight unless given. Unpickles arbitrary objects: load only
    checkpoints from a trusted source."""
    from visreps_tpu_torch.models.zoo import init_model

    device = resolve_device(device)
    _register_reference_stubs()
    payload = torch.load(path, map_location="cpu", weights_only=False)
    torch_model = payload["model"] if isinstance(payload, dict) and "model" in payload else payload
    sd = torch_model.state_dict()
    head_keys = [k for k in sd if k.endswith(".weight") and sd[k].ndim == 2]
    n_cls = num_classes or int(sd[head_keys[-1]].shape[0])
    name = "TinyCustomCNN" if model_name.lower().startswith("tiny") else model_name
    model = apply_torch_state_dict(init_model(name, n_cls, seed=0, device="cpu"), name, sd, n_cls)
    config = payload.get("config") if isinstance(payload, dict) else None
    rprint(f"  Imported reference checkpoint: {path} ({n_cls} classes)", style="success")
    return model.to(device).eval(), config
