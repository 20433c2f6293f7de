"""Device ms per frame of kernel K1 (csrc/wavefront.cu: every
wf_trace_kernel launch, explicit and camera mode)."""

PATTERNS = ("wf_trace_kernel",)


def is_k1(name):
    return any(p in name for p in PATTERNS)


def read(ctx):
    if ctx.trace is None or ctx.trace.empty:
        return None
    ms = ctx.trace.device_ms(is_k1)
    return ms if ms > 0 else None
