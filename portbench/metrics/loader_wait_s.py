"""Seconds per eval that the extraction waited on the host loader. Read
from ``evals.LAST_PHASE_TIMES["extraction_loader_s"]``: the sum over the
window's untraced evals over their number."""


def read(ctx):
    return ctx.per_eval("extraction_loader_s")
