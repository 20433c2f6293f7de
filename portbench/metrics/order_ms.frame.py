"""Device ms per frame of the ray order: K1's key kernel and the radix
sort's kernels (wavefront.ray_keys, ray_order)."""

PATTERNS = ("ray_key_kernel", "RadixSort")


def read(ctx):
    if ctx.trace is None or ctx.trace.empty:
        return None
    ms = ctx.trace.device_ms(lambda n: any(p in n for p in PATTERNS))
    return ms if ms > 0 else None
