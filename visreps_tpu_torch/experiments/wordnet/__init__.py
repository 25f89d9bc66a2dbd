"""WordNet-hierarchy labels (port of ``experiments/wordnet/``): the
hypernym hierarchy (a JSON snapshot or nltk), the exploration CLI and the
two label makers, depth 1–7 ancestor labels and the 8 semantic
super-categories."""
