"""Tracing and profiling (port of ``icpslam_tpu/utils/profiling.py``).

- :class:`StageTimer`: host wall-clock per named stage; ``block_on``
  synchronizes the current stream of each device its tensors lie on, so a
  stage's time holds its device work;
- :func:`trace`: a ``torch.profiler`` run (host and CUDA activity) that
  writes a Chrome / Perfetto trace, ``trace.json``, into a directory;
- :func:`annotate`: a named region in that trace;
- :func:`device_summary`: what a written trace says about the device —
  busy share, kernels and host launch calls, the costliest device ops.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterator, Optional

import torch

TRACE_FILE = "trace.json"


def _block(tree) -> None:
    """Synchronize the current stream of every CUDA device that a tensor
    in ``tree`` (a tensor, or tuples, lists and dicts of them) lies on."""
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                visit(v)

    visit(tree)
    for d in devices:
        torch.cuda.current_stream(d).synchronize()


class StageTimer:
    """Accumulate wall-clock per stage; blocks until device work finishes."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def _add(self, name: str, dt: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _block(block_on)
            self._add(name, time.perf_counter() - t0)

    def time_stage(self, name: str, fn, *args, **kwargs):
        """Run fn, block on its result, and record the stage time."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _block(out)
        self._add(name, time.perf_counter() - t0)
        return out

    def summary(self) -> Dict[str, dict]:
        return {
            k: {
                "total_s": round(self.totals[k], 6),
                "count": self.counts[k],
                "mean_ms": round(1000.0 * self.totals[k] / max(self.counts[k], 1), 3),
            }
            for k in sorted(self.totals)
        }

    def report(self) -> str:
        lines = [f"{'stage':30s} {'calls':>6s} {'mean ms':>10s} {'total s':>9s}"]
        for k, v in self.summary().items():
            lines.append(f"{k:30s} {v['count']:6d} {v['mean_ms']:10.3f} {v['total_s']:9.3f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (host ops, and CUDA activity where a card is
    present) and write ``logdir/trace.json`` (Chrome / Perfetto) at its
    end. Yields the profiler."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def annotate(name: str):
    """Named region in the profiler timeline (host-side spans)."""
    return torch.profiler.record_function(name)


# device activity in a Chrome trace written by torch.profiler
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                 "cudaGraphLaunch")


def device_summary(path: str, top: int = 5, window_us: Optional[float] = None) -> dict:
    """Read a trace written by :func:`trace` (``path``: the file or its
    directory). Returns the device-busy share (the union of device
    activity intervals over ``window_us``, by default the span of every
    complete event in the trace), the number of kernels the device ran,
    the host's kernel and graph launch calls, and the ``top`` device ops
    by total time."""
    if os.path.isdir(path):
        path = os.path.join(path, TRACE_FILE)
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in dev)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    if window_us is None:
        ts = [float(e["ts"]) for e in events]
        ends = [float(e["ts"]) + float(e.get("dur", 0.0)) for e in events]
        window_us = (max(ends) - min(ts)) if events else 0.0
    by_name: Dict[str, list] = {}
    for e in dev:
        x = by_name.setdefault(e["name"], [0.0, 0])
        x[0] += float(e.get("dur", 0.0))
        x[1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "window_us": window_us,
        "device_busy_us": busy,
        "device_busy_share": busy / window_us if window_us > 0 else 0.0,
        "kernels": sum(1 for e in dev if e.get("cat") == "kernel"),
        "launch_calls": sum(1 for e in events if e.get("name") in _LAUNCH_CALLS),
        "graph_launches": sum(1 for e in events if e.get("name") == "cudaGraphLaunch"),
        "top": [{"name": n, "total_us": v[0], "calls": v[1]} for n, v in ranked],
    }
