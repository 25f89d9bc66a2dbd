"""Stimulus transforms, the prefetching loader, NSD data loading, the
object-classification datasets and batch augmentation."""
