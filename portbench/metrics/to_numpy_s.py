"""Set-up (s) in DeviceOctree.to_numpy, the octree's node table copied to
the host: the program's last ``svo.to_numpy`` timer
(svo_raytracer_torch.utils.profiling.summary), read in a traced run
(portbench/spans.py)."""

from portbench import spans


def read(ctx):
    return spans.timer_s(ctx, "svo.to_numpy")
