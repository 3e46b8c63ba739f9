"""What a run hands to the metric readers (``benchmark/metrics/*.py``).

Per-scan lists are aligned with ``completions``, the host-clock stamps at
which each scan's step had finished on the device, in order, over every
replay of the window and the few scans the prefetch had read past its
end. ``n`` of them fall inside the window; readers use those. In a
``--trace 1`` run the host-clock readers read the untraced window and
the others its ``profiled`` twin, the traced window that follows it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from yardstick import timeline


@dataclasses.dataclass
class KernelShare:
    """Bound seconds and device seconds of one kernel's calls."""
    calls: int
    bound_s: float
    device_s: float


@dataclasses.dataclass
class TraceSummary:
    """What the profiler saw inside the window (device time, seconds)."""
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]   # the costliest device ops
    idle_gaps: List[Tuple[str, float]]    # idle device time by what the host was doing
    kernels: Dict[str, KernelShare]       # 'k1', 'k2'


@dataclasses.dataclass
class RunContext:
    seconds: float                      # the window's length
    start: float                        # the window's start (host clock)
    setup_s: float                      # process start to the window's start
    completions: List[float]
    step_s: List[float]                 # the program's own step time (RunResult.step_ms)
    host_syncs: List[float]             # counted host reads (RunResult.host_syncs)
    window_solves: List[float]          # RunResult.window_solves
    optimized: List[float]              # the record's 'optimized' flag
    implicit_syncs: Optional[List[float]] = None   # traced runs: syncs PyTorch made
    spans: Optional[Dict[str, List[float]]] = None  # traced runs: seconds per scan by span
    trace: Optional[TraceSummary] = None            # traced runs
    profiled: Optional["RunContext"] = None         # traced runs: the profiled window

    @property
    def n(self) -> int:
        """Scans completed inside the window."""
        return timeline.in_window(self.completions, self.start, self.seconds)
