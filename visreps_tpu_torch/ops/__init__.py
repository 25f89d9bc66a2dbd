"""Tensor ops of the evals: rank statistics, RDMs (with the Hopper RDM
kernel), sparse random projection, grouped bootstrap scoring, and the
encoding score's z-norms and ridge regression."""
