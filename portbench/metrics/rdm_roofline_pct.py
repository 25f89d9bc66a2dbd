"""The RDM kernel's share of its roofline in the traced eval: the sum of
``yardstick.rdm_bound_s`` over the kernel's launches, each at the (n, d)
and type its wrapper was handed (``probes/rdm_shapes.py``), over the
device time of the kernel's launches (``rdm_gram_kernel`` and
``rdm_reduce_kernel``) in the trace."""
from portbench.yardstick import rdm_bound_s

KERNELS = ("rdm_gram_kernel", "rdm_reduce_kernel")


def read(ctx):
    if ctx.trace is None or ctx.traced_eval is None:
        return None
    shapes = ctx.evals[ctx.traced_eval].get("rdm_shapes")
    device_s = sum(s for name, s in ctx.trace["op_s"].items()
                   if any(k in name for k in KERNELS))
    if not shapes or device_s <= 0:
        return None
    return 100.0 * sum(rdm_bound_s(n, d, t) for n, d, t in shapes) / device_s
