"""What a run hands to the metric readers (``benchmark/metrics/*.py``).

Per-scan lists are aligned with ``completions``, the host-clock stamps at
which each scan's step had finished on the device, in order, over every
replay of the window and the few scans the prefetch had read past its
end. ``n`` of them fall inside the window; readers use those. In a
``--trace 1`` run the host-clock readers read the untraced window and
the others its ``profiled`` twin, the traced window that follows it,
which runs under the program's own tracing: its ``program_spans`` and
``program_counts`` are ``RunResult.spans`` and ``RunResult.counts``
(``icpslam_tpu_torch/io/runner.py``) of each replay, under the program's
names, laid end to end.
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
    # launch calls and device seconds of the window scans' work, by the
    # innermost program span open on the calling thread (None: outside all)
    by_span: Dict[Optional[str], Tuple[int, float]] = dataclasses.field(default_factory=dict)
    launch_calls: int = 0                 # kernel and graph launch calls in the window


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
    # traced runs, per scan: the program's spans, name -> {"total", "self":
    # ms, "parent": its parent span}; its counters, name -> {"total" or the
    # innermost span counted in ("(none)": none) -> count}; the implicit
    # syncs by the innermost program span open when each was made (None: none)
    program_spans: Optional[Dict[str, dict]] = None
    program_counts: Optional[Dict[str, Dict[str, List[float]]]] = None
    implicit_by_span: Optional[Dict[Optional[str], List[float]]] = None
    trace: Optional[TraceSummary] = None            # traced runs
    profiled: Optional["RunContext"] = None         # traced runs: the profiled window

    @property
    def n(self) -> int:
        """Scans completed inside the window."""
        return timeline.in_window(self.completions, self.start, self.seconds)
