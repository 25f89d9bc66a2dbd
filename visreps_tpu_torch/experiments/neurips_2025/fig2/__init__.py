"""Fig. 2 of the paper (port of ``experiments/neurips_2025/fig2/``)."""
