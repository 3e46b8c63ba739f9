"""Window arithmetic on the host's clock: which scans completed inside the
measured window, the rate, each scan's time, its tail, the time outside
the steps, and the union of device-busy intervals.

Times are seconds on one clock (``time.perf_counter`` for the host, the
profiler's nanoseconds converted for the device); nothing here reads a
clock.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def in_window(completions: Sequence[float], start: float, seconds: float) -> int:
    """How many of the (ascending) completion stamps fall inside
    ``[start, start + seconds]``: the scans completed in the window."""
    end = start + seconds
    n = 0
    for c in completions:
        if c > end:
            break
        if c < start:
            raise ValueError("a completion precedes the window's start")
        n += 1
    return n


def scan_times(completions: Sequence[float], start: float, seconds: float) -> np.ndarray:
    """Each window scan's time: from the previous completion (or the
    window's start) to its own completion. Whatever the host did between
    two completions (a replay's re-initialisation, the prefetch, a stall)
    lands in the next scan's time."""
    n = in_window(completions, start, seconds)
    c = np.asarray(completions[:n], np.float64)
    return np.diff(np.concatenate([[start], c]))


def rate(completions: Sequence[float], start: float, seconds: float) -> float:
    """Scans completed in the window over the window's length."""
    return in_window(completions, start, seconds) / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile, linear between the closest ranks (numpy's
    default)."""
    v = np.asarray(values, np.float64)
    if v.size == 0:
        raise ValueError("no values")
    return float(np.percentile(v, q))


def host_gap(completions: Sequence[float], start: float, seconds: float,
             step_s: Sequence[float]) -> float:
    """Seconds from the window's start to its last completion not spent
    inside the window scans' steps (``step_s``, aligned with
    ``completions``)."""
    n = in_window(completions, start, seconds)
    if n == 0:
        return 0.0
    return max(float(completions[n - 1] - start) - float(np.sum(step_s[:n])), 0.0)


def union(starts: np.ndarray, ends: np.ndarray, lo: float, hi: float
          ) -> Tuple[float, np.ndarray, np.ndarray]:
    """The union of the intervals ``[starts[i], ends[i]]`` clipped to
    ``[lo, hi]``: its length, and the starts and ends of the gaps of
    ``[lo, hi]`` outside it. One pass over the intervals in order of
    start: the union's running end is a running maximum, and its length a
    sequential sum (``cumsum``)."""
    a, b = np.asarray(starts, np.float64), np.asarray(ends, np.float64)
    keep = (b > lo) & (a < hi)
    a, b = np.maximum(a[keep], lo), np.minimum(b[keep], hi)
    order = np.lexsort((b, a))
    a, b = a[order], b[order]
    # the union's end as each interval comes
    end = np.maximum.accumulate(np.concatenate([[lo], b]))
    before, last = end[:-1], float(end[-1])
    grows = b > before
    part = np.where(grows, b - np.maximum(a, before), 0.0)
    total = float(np.cumsum(part)[-1]) if part.size else 0.0
    opens = a > before
    g0, g1 = before[opens], a[opens]
    if hi > last:
        g0, g1 = np.append(g0, last), np.append(g1, hi)
    return total, g0, g1
