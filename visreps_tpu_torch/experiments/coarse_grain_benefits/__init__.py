"""Coarse-grain-benefit experiments on trained checkpoints (port of
``experiments/coarse_grain_benefits/``)."""
