"""Seconds per eval of phase 2: the exact taps of the chosen layers and
their RDMs. Read from ``evals.LAST_PHASE_TIMES["phase2_extract_s"]``:
the sum over the window's untraced evals over their number."""


def read(ctx):
    return ctx.per_eval("phase2_extract_s")
