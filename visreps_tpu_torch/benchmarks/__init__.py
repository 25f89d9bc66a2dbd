"""On-disk synthetic NSD fixture for exercising the eval end to end."""
