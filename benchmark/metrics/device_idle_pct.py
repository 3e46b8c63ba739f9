"""The window's share in which no kernel, copy or memset ran on the card,
% (the union of device intervals in the trace)."""


def read(ctx):
    t = ctx.profiled.trace if ctx.profiled is not None else None
    if t is None or t.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
