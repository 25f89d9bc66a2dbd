"""PCA eigenvectors and coarse labels (port of ``scripts/coarsegrain/``)."""
