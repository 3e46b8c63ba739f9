"""Window wall time not covered by the steps (``RunResult.step_ms``),
ms per window scan: re-initialisation, the drive loop, the prefetch."""
from yardstick import timeline


def read(ctx):
    n = ctx.n
    if n == 0:
        return None
    return 1000.0 * timeline.host_gap(ctx.completions, ctx.start, ctx.seconds, ctx.step_s) / n
