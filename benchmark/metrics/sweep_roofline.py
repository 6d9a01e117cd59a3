"""sweep_roofline: the sweep kernels' share of their roofline: the
summed frozen bounds of the emit and absorb launches in the trace (one
emit a call writes the dtaus diagnostic) over their summed device time,
in %.  Nothing when the trace has no sweep launch."""

from benchmark.reference import counts


def read(run):
    t = run.window.trace
    if not t:
        return None
    n_emit, n_absorb = t.count("emit_kernel"), t.count("absorb_kernel")
    if not n_emit + n_absorb:
        return None
    ctx = run.ctx
    B, (L, W, S, nT) = ctx.columns, run.shape()
    dt = ctx.cfg["dtype"]
    e = counts.ELEM_BYTES[dt]
    pop = ctx.cfg["planet"]["kind"] == "population"
    flops = counts.sweep_flops(B, L, W, S)
    n_final = min(len(t.calls), n_emit)

    def b(direction, n, **kw):
        return n * counts.bound_s(counts.sweep_bytes(
            direction, B, L, W, S, nT, e, per_column=pop, **kw), flops,
            dt)[0]
    bound = (b("emit", n_emit - n_final) + b("emit", n_final, with_dtaus=True)
             + b("absorb", n_absorb))
    return 100.0 * bound / (t.seconds("emit_kernel")
                            + t.seconds("absorb_kernel"))
