"""Device kernels per frame (kernel records in the trace over the traced
frames)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.empty:
        return None
    return ctx.trace.kernels_per_unit()
