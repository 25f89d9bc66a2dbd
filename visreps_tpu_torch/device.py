"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` unless the caller asks for the CPU by name.

    Raises when CUDA is absent and the CPU was not asked for — there is
    no silent CPU fallback. Also turns off TF32 and reduced-precision
    bf16 reductions, so f32 Grams and convolutions run in full f32
    (the JAX package's ``Precision.HIGHEST`` RDM and f32 extractor).
    """
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (--device cpu) "
                "to run the port on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def input_device(x, device=None) -> torch.device:
    """``device`` if given, else the device of tensor ``x``. A numpy input
    without a device raises: the caller names where the work runs."""
    if device is not None:
        return torch.device(device)
    if isinstance(x, torch.Tensor):
        return x.device
    raise ValueError("pass device= for non-tensor inputs")
