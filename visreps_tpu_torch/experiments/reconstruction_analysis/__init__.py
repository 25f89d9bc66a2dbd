"""The PC-reconstruction sweep and its figure (port of
``experiments/reconstruction_analysis/``)."""
