"""Fig. 3 of the paper (port of ``experiments/neurips_2025/fig3/``)."""
