"""Attribute-access config dict (port of ``visreps_tpu/config.py``).

``ConfigDict`` is kept for the reference's API (its visreps/config.py);
the run path uses ``visreps_tpu_torch.core.config.Config``.
"""
from visreps_tpu_torch.core.config import Config as ConfigDict  # noqa: F401

__all__ = ["ConfigDict"]
