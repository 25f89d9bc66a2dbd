"""Low-rank PCA reconstruction control (port of
``visreps_tpu/analysis/reconstruct_from_pcs.py``, a re-export)."""
from visreps_tpu_torch.ops.pca import reconstruct_from_pcs

__all__ = ["reconstruct_from_pcs"]
