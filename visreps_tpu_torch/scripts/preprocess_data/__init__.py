"""Neural-data builders (port of ``scripts/preprocess_data/``): each
turns per-(region, subject) npz files, or a reference pickle, into the
pickle the evals' loaders read. Host code only."""
