"""Seconds per eval of the RSA layer selection (phase 1). Read from
``evals.LAST_PHASE_TIMES["phase1_selection_s"]``: the sum over the
window's untraced evals over their number."""


def read(ctx):
    return ctx.per_eval("phase1_selection_s")
