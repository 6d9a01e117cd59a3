"""rc_loop_roofline: the whole-loop kernel's share of its roofline, the
frozen bound of one fixed-horizon loop (benchmark/reference/counts.py)
over the mean device time of the launches named ``loop_kernel`` in the
trace, in %.  Nothing when the trace has no such launch."""

from benchmark.reference import counts

KERNEL = "loop_kernel"


def read(run):
    t = run.window.trace
    n = t.count(KERNEL) if t else 0
    if not n:
        return None
    ctx = run.ctx
    B, L, W, S, nT = ctx.columns, *run.shape()
    dt = ctx.cfg["dtype"]
    n_it = int(ctx.traffic["iterations"])
    bound, _ = counts.bound_s(
        counts.loop_bytes(B, L, W, S, nT, counts.ELEM_BYTES[dt], n_it),
        counts.loop_flops(B, L, W, S, n_it), dt)
    return 100.0 * bound * n / t.seconds(KERNEL)
