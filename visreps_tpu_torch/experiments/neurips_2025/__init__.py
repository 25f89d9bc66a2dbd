"""The paper's figure scripts (port of ``experiments/neurips_2025/``): each
CLI computes its series without pandas and draws where matplotlib imports."""
