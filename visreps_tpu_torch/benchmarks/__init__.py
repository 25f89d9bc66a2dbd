"""On-disk synthetic fixtures (NSD, THINGS, TVSD, NSD-Synthetic,
ImageNet) for exercising the evals and training end to end."""
