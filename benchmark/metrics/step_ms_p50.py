"""Median of the window scans' step times, ms (``RunResult.step_ms``)."""
import numpy as np


def read(ctx):
    n = ctx.n
    return 1000.0 * float(np.median(ctx.step_s[:n])) if n else None
