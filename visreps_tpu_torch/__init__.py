"""visreps_tpu_torch: the PyTorch/CUDA port of visreps_tpu.

Covers the NSD RSA eval (AlexNet taps → SRP → phase-1 layer selection →
exact phase-2 RDMs → grouped Spearman scoring with bootstrap CIs →
results.db). Entry points run on CUDA unless the caller passes
``device="cpu"``; the correlation-RDM Gram runs in a hand-written Hopper
kernel (``csrc/rdm.cu``) on the card. Imports torch, never JAX, and
nothing of ``visreps_tpu``.
"""
