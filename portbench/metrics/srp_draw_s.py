"""Seconds per eval of drawing the SRP matrices, on the card: the
``device_s`` (CUDA events) of the ``srp.draw`` spans inside
``extraction`` (``ops/srp.py``, one per tap width the eval meets without
its matrix; ``probes/spans.py``), summed over each of the window's
untraced evals, over their number."""
from portbench import cells


def read(ctx):
    return cells.find("probes", "spans", ctx.cell["root"]).per_eval(
        ctx, "srp.draw", under="extraction")
