"""World generation (s): the harness's host-clock span around the world's
build on the device (models/procgen, models/world.build_world,
core/build_device), ended by a synchronize."""


def read(ctx):
    return ctx.spans.get("world_s")
