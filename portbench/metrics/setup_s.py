"""Set-up (s): from the process's start to the first timed unit: imports,
the card's start, the world's build, the tables, the kernels' load (their
build on a checkout's first run) and the warm units."""


def read(ctx):
    return ctx.setup_s
