"""Seconds per eval of the model load's build and random init on the CPU,
by the host clock: the ``zoo.init`` spans inside ``model_load``
(``models/zoo.init_model``; ``probes/spans.py``), summed over each of the
window's untraced evals, over their number. Host seconds: the card idles meanwhile, so the span's
CUDA events would time the same wait."""
from portbench import cells


def read(ctx):
    spans = cells.find("probes", "spans", ctx.cell["root"])
    return spans.per_eval(ctx, "zoo.init", of=spans.host_s, under="model_load")
