"""Command-line pipelines of the port (counterparts of the repository's
``scripts/``), each run as ``python -m visreps_tpu_torch.scripts.<path>``."""
