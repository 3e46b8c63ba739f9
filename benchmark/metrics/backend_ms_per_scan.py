"""Host time inside the back end (``slam._try_loop_closure`` and
``slam._optimize``) per window scan, ms (the benchmark's spans; no
synchronize)."""


def read(ctx):
    ctx = ctx.profiled  # the traced window
    if ctx is None or ctx.spans is None or ctx.n == 0:
        return None
    n = ctx.n
    total = sum(ctx.spans["bench.loop_closure"][:n]) + sum(ctx.spans["bench.optimize"][:n])
    return 1000.0 * total / n
