"""Models with named activation taps, the tap extractor, and weight
carry-over from the JAX package."""
