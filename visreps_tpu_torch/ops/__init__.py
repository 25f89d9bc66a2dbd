"""Tensor ops of the eval: rank statistics, RDMs (with the Hopper RDM
kernel), sparse random projection and grouped bootstrap scoring."""
