"""Device kernels per frame under the program's ``svo.shade`` span
(shading: shade.gi_update after each segment of a mode-0 frame, the
colour and shadow-ray code in modes 1-3): the kernel records whose host
launch lies innermost in that span (portbench/spans.py)."""

from portbench import spans


def read(ctx):
    return spans.read(ctx, "svo.shade", "kernels")
