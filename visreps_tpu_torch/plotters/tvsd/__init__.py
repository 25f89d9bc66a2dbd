"""The tvsd coarseness figures (port of ``plotters/tvsd/``)."""
