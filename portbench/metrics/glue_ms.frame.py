"""Device ms per frame of frame assembly and shading: every kernel,
memcpy and memset record that is neither K1 nor the ray order."""

NOT_GLUE = ("wf_trace_kernel", "ray_key_kernel", "RadixSort")


def read(ctx):
    if ctx.trace is None or ctx.trace.empty:
        return None
    return ctx.trace.device_ms(lambda n: not any(p in n for p in NOT_GLUE))
