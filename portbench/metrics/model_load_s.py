"""Seconds per eval of the model load: CPU init, the torchvision weight
import, the copy to the card. Read from
``evals.LAST_PHASE_TIMES["model_load_s"]``: the sum over the window's
untraced evals over their number."""


def read(ctx):
    return ctx.per_eval("model_load_s")
