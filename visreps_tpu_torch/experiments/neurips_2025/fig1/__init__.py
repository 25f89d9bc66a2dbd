"""Fig. 1 of the paper (port of ``experiments/neurips_2025/fig1/``)."""
