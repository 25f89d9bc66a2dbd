"""The semantic analyses (port of ``experiments/semantic_analysis/``):
fine-grained structure, semantic alignment, PC-pole enrichment and the
semantic-class embedding grid."""
