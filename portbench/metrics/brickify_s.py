"""Set-up (s) in brick_scene.brickify, the octree decomposed into bricks on
the host: the program's last ``svo.brickify`` timer
(svo_raytracer_torch.utils.profiling.summary), read in a traced run
(portbench/spans.py)."""

from portbench import spans


def read(ctx):
    return spans.timer_s(ctx, "svo.brickify")
