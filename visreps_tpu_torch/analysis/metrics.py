"""Metric library (re-export of ``ops/metrics.py``, as
``visreps_tpu/analysis/metrics.py`` re-exports the JAX one)."""
from visreps_tpu_torch.ops.metrics import cka, covariance, hsic, pearson_r, r2_score, spearman_r

__all__ = ["pearson_r", "spearman_r", "covariance", "r2_score", "cka", "hsic"]
