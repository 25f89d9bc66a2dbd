"""Config, logging, environment and results-DB helpers (copies of the
JAX package's ``core/``, trimmed to what the port uses)."""
