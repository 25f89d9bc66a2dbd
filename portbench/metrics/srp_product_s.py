"""Seconds per eval of the SRP products of every tap, on the card: the self
``device_s`` (CUDA events) of the ``extractor.srp_product`` spans inside
``extraction`` (``models/extractor.py``), each less its
``srp.draw`` children (``ops/srp.py``; ``probes/spans.py``),
summed over each of the window's untraced evals, over their number. It
holds the HWC flatten of each tap and its bf16 cast besides the GEMM."""
from portbench import cells


def read(ctx):
    return cells.find("probes", "spans", ctx.cell["root"]).per_eval(
        ctx, "extractor.srp_product", under="extraction", self_time=True)
