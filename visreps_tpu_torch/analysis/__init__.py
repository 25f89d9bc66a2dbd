"""Analysis protocols: RSA phase-1 layer selection, stimulus alignment
and the encoding score."""
