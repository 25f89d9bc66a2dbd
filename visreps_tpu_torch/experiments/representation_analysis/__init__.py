"""The representation analyses (port of ``experiments/representation_analysis/``):
dimensionality, variance ratio, nearest neighbours, RSM comparison,
task–brain alignment, two-PC quadrants and their sweep."""
