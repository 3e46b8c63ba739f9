"""The 95th percentile of the window scans' times, ms, each from the
previous completion (or the window's start) to its own (host clock; in a
``--trace 1`` run, of the untraced window). A per-layer metric: from run
to run it spreads wider than an end-to-end bound can hold (PERF.md §2)."""
from yardstick import timeline


def read(ctx):
    times = timeline.scan_times(ctx.completions, ctx.start, ctx.seconds)
    return 1000.0 * timeline.percentile(times, 95) if times.size else None
