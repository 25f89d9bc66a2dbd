"""The things coarseness figures (port of ``plotters/things/``)."""
