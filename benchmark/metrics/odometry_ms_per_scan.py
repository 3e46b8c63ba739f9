"""Host time inside ``odometry.odometry_step`` per window scan, ms (the
benchmark's span; no synchronize)."""


def read(ctx):
    ctx = ctx.profiled  # the traced window
    if ctx is None or ctx.spans is None or ctx.n == 0:
        return None
    n = ctx.n
    return 1000.0 * sum(ctx.spans["bench.odometry"][:n]) / n
