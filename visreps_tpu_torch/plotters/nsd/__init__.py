"""The nsd coarseness figures (port of ``plotters/nsd/``)."""
