"""Device ms per frame under the program's ``svo.prep`` span (the segment's
input: explicit rays to voxel units with their alive mask
(wavefront._rays), or the camera-mode scalars (cam16)): the kernel,
memcpy and memset records whose host launch lies innermost in that span
(portbench/spans.py)."""

from portbench import spans


def read(ctx):
    return spans.read(ctx, "svo.prep", "ms")
