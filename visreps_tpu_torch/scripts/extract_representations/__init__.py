"""Source-model feature extraction for PCA labels (port of
``scripts/extract_representations/``)."""
