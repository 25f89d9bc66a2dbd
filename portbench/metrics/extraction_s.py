"""Seconds per eval of the extraction: the forward, the SRP of every tap
and the store. Read from ``evals.LAST_PHASE_TIMES["extraction_s"]``: the
sum over the window's untraced evals over their number."""


def read(ctx):
    return ctx.per_eval("extraction_s")
