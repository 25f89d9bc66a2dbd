"""The whole eval's share of the card's peak: the least time the card could
take for the work of the window's untraced evals over their seconds by
the host's clock (the profiled eval's own time is the profiler's too).
Counted: the forward once per stimulus at the f32 FMA peak (operations
by ``torch.utils.flop_counter`` on the cell's model layout,
``models/<model>.py``), each SRP product of a tap wider than k (2·D·k a
stimulus) at the bf16 peak, and the analysis's own work at its bound
(``analyses/<reference>.py``'s ``device_work_s``: for RSA each RDM the
eval handed the kernel, by ``yardstick.rdm_bound_s``). Not counted:
phase 2's re-extraction (recomputation of taps already made once) and
the bootstrap (sort and scan work, no peak to hold it to). Nothing is
returned where the analysis's work was not recorded."""
import torch

from portbench import cells, yardstick


def read(ctx):
    evals = ctx.untraced()
    wall = sum(e["wall_s"] for e in evals)
    cell = ctx.cell
    analysis = cells.analysis(cell)
    own = [analysis.device_work_s(cell, e) for e in evals]
    if wall <= 0 or any(v is None for v in own):
        return None
    model = cells.model(cell)
    size = int(cell["image_size"])
    fwd = yardstick.forward_ops(model.build(), size)
    with torch.device("meta"):
        meta = model.build()
    taps = model.taps(meta, torch.empty((1, 3, size, size), device="meta"), cell["taps"])
    k = int(cell["srp_k"])
    srp = sum(yardstick.srp_ops(t.shape[1], k) for t in taps.values() if t.shape[1] > k)
    n = cells.dataset(cell).n_stimuli(cell)
    per_eval = (n * fwd / yardstick.FMA_PEAK_OPS["float32"]
                + n * srp / yardstick.FMA_PEAK_OPS["bfloat16"])
    return 100.0 * (per_eval * len(evals) + sum(own)) / wall
