"""GB of SRP matrices drawn per eval: the ``bytes`` counts (2·D·min(D, k)
of bf16 a tap width D) of the ``srp.draw`` spans inside
``extraction`` (``ops/srp.py``; ``probes/spans.py``), summed over each of
the window's untraced evals, over their number, / 1e9. A count, the same
on every run of a configuration."""
from portbench import cells


def read(ctx):
    gb = cells.find("probes", "spans", ctx.cell["root"]).per_eval(
        ctx, "srp.draw", of=lambda r: r["counts"]["bytes"], under="extraction")
    return None if gb is None else gb / 1e9
