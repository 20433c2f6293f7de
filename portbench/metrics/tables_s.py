"""Scene tables (s): the harness's host-clock span around the tables'
build: tree.to_numpy, brick_scene.brickify and wavefront.prepare, or, in
the viewer, its construction and Viewer.pre_run; ended by a synchronize."""


def read(ctx):
    return ctx.spans.get("tables_s")
