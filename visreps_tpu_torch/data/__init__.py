"""Stimulus transforms, the prefetching loader and NSD data loading."""
