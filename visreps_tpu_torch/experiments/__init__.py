"""Experiments of the port (counterparts of the repository's
``experiments/``), each run as ``python -m visreps_tpu_torch.experiments.<path>``."""
