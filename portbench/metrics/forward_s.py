"""Seconds per eval of the all-tap forward of the extraction, on the card:
the ``device_s`` (CUDA events) of the ``extractor.forward`` spans inside
``extraction`` (``models/extractor.py``; ``probes/spans.py``), summed over
each of the window's untraced evals, over their number."""
from portbench import cells


def read(ctx):
    return cells.find("probes", "spans", ctx.cell["root"]).per_eval(
        ctx, "extractor.forward", under="extraction")
