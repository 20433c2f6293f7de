"""Set-up (s) in wavefront.prepare, the wavefront tables built on the host
and copied to the card, ended by a synchronize: the program's last
``svo.prepare`` timer (svo_raytracer_torch.utils.profiling.summary),
read in a traced run (portbench/spans.py)."""

from portbench import spans


def read(ctx):
    return spans.timer_s(ctx, "svo.prepare")
