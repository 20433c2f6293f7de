"""Time per frame (ms): the window's seconds over the frames it
completed, each frame ended as its user sees it (a synchronize, or the
viewer's crosshair readback)."""


def read(ctx):
    return ctx.window_s * 1e3 / ctx.units
