"""Stimulus transforms, the prefetching loader, neural data loading
(NSD, NSD-Synthetic, THINGS, TVSD, Cusack), the object-classification
datasets and batch augmentation."""
