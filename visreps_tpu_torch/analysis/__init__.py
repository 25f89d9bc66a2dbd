"""RSA protocol pieces (phase-1 layer selection)."""
