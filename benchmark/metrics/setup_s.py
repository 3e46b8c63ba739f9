"""Process start to the window's start, seconds (host clock)."""


def read(ctx):
    return ctx.setup_s
