"""Device kernels per frame under the program's ``svo.decode`` span (the
hit decode: trace records to a HitResult (wavefront._finish,
brick_trace.decode_hits)): the kernel records whose host launch lies
innermost in that span (portbench/spans.py)."""

from portbench import spans


def read(ctx):
    return spans.read(ctx, "svo.decode", "kernels")
