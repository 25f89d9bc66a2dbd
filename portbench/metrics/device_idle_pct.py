"""Share of the traced eval in which no operation ran on the card: 100 ·
(1 − busy / window), the busy time being the union of the trace's
kernel, memcpy and memset intervals (``yardstick.summarize_trace``)."""


def read(ctx):
    t = ctx.trace
    if t is None or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
