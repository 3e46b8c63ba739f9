"""Scans completed inside the window over its length (host clock)."""
from yardstick import timeline


def read(ctx):
    return timeline.rate(ctx.completions, ctx.start, ctx.seconds)
