"""Training: the optimizer chain, checkpoints in the JAX package's
format, and the trainer."""
