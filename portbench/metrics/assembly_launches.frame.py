"""Device kernels per frame under the program's ``svo.assembly`` span
(frame assembly: the frame's rays, the per-pixel random, the GI
accumulators and the image's unblocking (render_wave)): the kernel
records whose host launch lies innermost in that span
(portbench/spans.py)."""

from portbench import spans


def read(ctx):
    return spans.read(ctx, "svo.assembly", "kernels")
