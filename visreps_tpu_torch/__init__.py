"""visreps_tpu_torch: the PyTorch/CUDA port of visreps_tpu.

Covers training (CustomCNN on PCA-coarsened labels, checkpoints in the
JAX package's format) and the evals of an untrained AlexNet or a
checkpoint against NSD and TVSD (RSA: model taps → SRP → phase-1 layer
selection → exact phase-2 RDMs → grouped Spearman scoring with bootstrap
CIs → results.db; or the encoding score), THINGS behaviour
(concept-level RSA) and NSD-Synthetic (RSA on NSD-selected layers).
Entry points run on CUDA unless the caller passes ``device="cpu"``; the
correlation-RDM Gram runs in a hand-written Hopper kernel
(``csrc/rdm.cu``) on the card. Imports torch, never JAX, and nothing of
``visreps_tpu``.
"""
