"""Full graph solves per 100 window scans: the step's solves (the
record's ``optimized`` flag) less the window solves
(``RunResult.window_solves``)."""


def read(ctx):
    n = ctx.n
    if n == 0:
        return None
    return 100.0 * (sum(ctx.optimized[:n]) - sum(ctx.window_solves[:n])) / n
