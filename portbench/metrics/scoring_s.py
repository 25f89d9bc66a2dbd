"""Seconds per eval of the point scores and the bootstrap. Read from
``evals.LAST_PHASE_TIMES["scoring_bootstrap_s"]``: the sum over the
window's untraced evals over their number."""


def read(ctx):
    return ctx.per_eval("scoring_bootstrap_s")
