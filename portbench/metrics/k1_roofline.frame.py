"""Kernel K1's share (%) of its roofline: the least time K1's work needs
on an H100 (portbench/roofline.py: bytes over 3.35 TB/s or operations over
67 TFLOP/s, the work counted by the reference walk on the sampled pixels
of the traced frames' segments and scaled to the frame) over K1's device
time per frame."""

from portbench import roofline
from portbench.reference.walk import distinct_words

PATTERNS = ("wf_trace_kernel",)


def read(ctx):
    if ctx.trace is None or ctx.trace.empty or not ctx.walks:
        return None
    k1 = ctx.trace.device_ms(lambda n: any(p in n for p in PATTERNS))
    if k1 <= 0:
        return None
    scale = ctx.frame_pixels / ctx.pixels
    least = [roofline.frame_least_ms(
        [dict(s, words=distinct_words(s)) for s in frame], scale)
        for frame in ctx.walks]
    return sum(least) / len(least) / k1 * 100.0
