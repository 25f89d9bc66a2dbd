"""The nsd_synthetic coarseness figures (port of ``plotters/nsd_synthetic/``)."""
