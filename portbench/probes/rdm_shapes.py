"""Records the (n, d, dtype) of every RDM handed to the kernel's wrapper,
``visreps_tpu_torch.ops.rdm.rdm_from_centered``, on the card.

A probe file gives ``install()``, which returns an object with ``take()``
(what it recorded since the last take: kept in each eval's record under
the probe's name) and ``close()``. The harness installs every probe in
``--trace 1`` runs only.
"""
from __future__ import annotations


class _Probe:
    def __init__(self):
        from visreps_tpu_torch.ops import rdm

        self.mod, self.orig, self.shapes = rdm, rdm.rdm_from_centered, []

        def probe(xc, std, correction=1e-12):
            if xc.is_cuda:
                self.shapes.append((xc.shape[0], xc.shape[1], str(xc.dtype).split(".")[-1]))
            return self.orig(xc, std, correction)

        rdm.rdm_from_centered = probe

    def take(self) -> list:
        out, self.shapes = self.shapes, []
        return out

    def close(self):
        self.mod.rdm_from_centered = self.orig


def install():
    return _Probe()
