"""The 95th percentile (ms) of the host-clock latency of every frame of
the window."""

from portbench.harness import p95


def read(ctx):
    return p95(ctx.latencies) * 1e3
