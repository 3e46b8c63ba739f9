"""Tracing and profiling: the port's spans and counters, and
``torch.profiler`` traces (port of ``icpslam_tpu/utils/profiling.py``).

Tracing is off by default; :func:`tracing` turns it on for a block, and
so does :func:`trace`, which also profiles the block.

- :func:`annotate` (a ``with`` block) and :func:`spanned` (a whole
  function) open a span. Off, that costs one check and opens nothing. On,
  the span opens ``torch.profiler.record_function``, so it lands in a
  profiler trace on the clock of the device activity, and adds its host
  time (``perf_counter_ns``), its self time (its time less its child
  spans') and its calls to totals by name, with its parent span;
- :func:`count` adds to a counter, always; while tracing is on, it also
  adds to a copy keyed by the innermost span open on the calling thread
  (:func:`current`). :func:`register_attribute` makes a call counter kept
  as a function attribute (``nn1_cuda.launches``) a counter too;
- :func:`snapshot` and :func:`delta` give the counters and span totals and
  their differences; :func:`paused` stops counting for its block;
- :func:`device_summary` reads a written trace: the device-busy share,
  kernels and launch calls, the costliest device ops, and the launches and
  device time of each innermost span (:func:`attribute`).

The registry is the process's, and takes no lock: each name is updated
on one thread (the counters and spans on the thread that steps, the span
``runner.upload`` on the prefetch thread).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import threading
import time
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

TRACE_FILE = "trace.json"

_on = False
_paused = 0
_counts: Dict[str, float] = {}
_by_span: Dict[Tuple[Optional[str], str], float] = {}   # (innermost span, counter)
_spans: Dict[str, List[int]] = {}                        # name -> [calls, total ns, self ns]
_parents: Dict[str, Optional[str]] = {}                  # name -> its parent span, last seen
_attributes: Dict[str, Tuple[object, str]] = {}          # counter -> (owner, attribute)
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Off:
    """The shared span of the off path: enters and exits nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "parent", "child_ns", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.child_ns = 0
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        self.rf.__exit__(*exc)
        _stack().pop()
        rec = _spans.get(self.name)
        if rec is None:
            rec = _spans[self.name] = [0, 0, 0]
        rec[0] += 1
        rec[1] += dt
        rec[2] += dt - self.child_ns
        if self.parent is not None:
            self.parent.child_ns += dt
        _parents[self.name] = self.parent.name if self.parent is not None else None
        return False


def enabled() -> bool:
    """Whether tracing is on."""
    return _on


@contextlib.contextmanager
def tracing(on: bool = True) -> Iterator[None]:
    """Turn tracing on (or off) for the block."""
    global _on
    before = _on
    _on = on
    try:
        yield
    finally:
        _on = before


def annotate(name: str):
    """A span named ``name`` over a ``with`` block (see the module)."""
    if not _on:
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorator: each call of the function is a span named ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return wrapped
    return wrap


def current() -> Optional[str]:
    """The innermost span open on the calling thread, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1].name if stack else None


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name`` (see the module)."""
    if _paused:
        return
    _counts[name] = _counts.get(name, 0) + n
    if _on:
        key = (current(), name)
        _by_span[key] = _by_span.get(key, 0) + n


def register_attribute(name: str, owner, attribute: str) -> None:
    """Read the call counter ``owner.attribute`` as the counter ``name``
    in :func:`snapshot`; :func:`paused` leaves it as it was."""
    _attributes[name] = (owner, attribute)


@contextlib.contextmanager
def paused() -> Iterator[None]:
    """Count nothing in the block (a capture running a solve's body)."""
    global _paused
    saved = {name: getattr(owner, attr) for name, (owner, attr) in _attributes.items()}
    _paused += 1
    try:
        yield
    finally:
        _paused -= 1
        for name, (owner, attr) in _attributes.items():
            setattr(owner, attr, saved[name])


def snapshot() -> dict:
    """The counters (``counts``: name -> total), the counters by innermost
    span (``by_span``: (span, name) -> total), the span totals (``spans``:
    name -> (calls, total ns, self ns)) and each span's parent
    (``parents``)."""
    counts = dict(_counts)
    for name, (owner, attr) in _attributes.items():
        counts[name] = getattr(owner, attr)
    # list(): one step under the interpreter lock, while the prefetch
    # thread may close its first span
    spans = {k: tuple(v) for k, v in list(_spans.items())}
    return {"counts": counts, "by_span": dict(_by_span), "spans": spans,
            "parents": dict(_parents)}


def delta(before: dict, after: dict) -> dict:
    """What changed from the snapshot ``before`` to ``after``: ``counts``
    and ``by_span`` differences, and ``spans`` (calls, total ns, self ns)
    of the spans that closed in between."""
    def diff(a: dict, b: dict) -> dict:
        return {k: v - a.get(k, 0) for k, v in b.items() if v != a.get(k, 0)}

    spans = {}
    for name, (calls, total, own) in after["spans"].items():
        c0, t0, s0 = before["spans"].get(name, (0, 0, 0))
        if calls != c0:
            spans[name] = (calls - c0, total - t0, own - s0)
    return {"counts": diff(before["counts"], after["counts"]),
            "by_span": diff(before["by_span"], after["by_span"]), "spans": spans}


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block with tracing on (host ops and spans, and CUDA
    activity where a card is present) and write ``logdir/trace.json``
    (Chrome / Perfetto) at its end. Yields the profiler."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with tracing(True), torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


# device activity in a Chrome trace written by torch.profiler
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_CALL_CATS = ("cuda_runtime", "cuda_driver")
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                 "cudaGraphLaunch")


def _innermost(spans: Iterable[Tuple[object, float, float, str]], threads: Sequence,
              times: Sequence[float]) -> List[Optional[str]]:
    """The innermost of ``spans`` ((thread, start, end, name), nested on
    each thread) open at each (``threads[i]``, ``times[i]``), or None."""
    by_thread: Dict[object, list] = collections.defaultdict(list)
    for thread, a, b, name in spans:
        by_thread[thread].append((a, b, name))
    # each thread's timeline as segments [starts[i], starts[i + 1]) -> labels[i]
    segments = {}
    for thread, items in by_thread.items():
        items.sort(key=lambda s: (s[0], -s[1]))
        starts, labels, open_ = [], [], []
        for a, b, name in items:
            while open_ and open_[-1][0] <= a:
                starts.append(open_.pop()[0])
                labels.append(open_[-1][1] if open_ else None)
            open_.append((b, name))
            starts.append(a)
            labels.append(name)
        while open_:
            starts.append(open_.pop()[0])
            labels.append(open_[-1][1] if open_ else None)
        segments[thread] = (np.asarray(starts, np.float64), labels)
    rows_of: Dict[object, List[int]] = collections.defaultdict(list)
    for i, thread in enumerate(threads):
        rows_of[thread].append(i)
    times = np.asarray(times, np.float64)
    out: List[Optional[str]] = [None] * len(times)
    for thread, rows in rows_of.items():
        if thread not in segments:
            continue
        starts, labels = segments[thread]
        seg = np.searchsorted(starts, times[rows], side="right") - 1
        for r, s in zip(rows, seg.tolist()):
            if s >= 0:
                out[r] = labels[s]
    return out


def attribute(spans: Iterable[Tuple[object, float, float, str]],
              calls: Sequence[Tuple[object, float, int, str]],
              device: Sequence[Tuple[int, float]]) -> Dict[Optional[str], dict]:
    """Launch calls and device time by the span that made them.

    ``spans``: (thread, start, end, name); ``calls``: (thread, time,
    correlation id, name) of the host's runtime and driver calls;
    ``device``: (correlation id, duration) of the kernels, copies and
    memsets. A call belongs to the innermost span open on its own thread
    at its time, a device event to the span of its call. Returns
    ``{span: {"launches": kernel and graph launch calls, "device": total
    duration}}``; calls outside every span, and device events of no
    recorded call, under None."""
    labels = _innermost(spans, [x[0] for x in calls], [x[1] for x in calls])
    codes: Dict[Optional[str], int] = {}
    call_code = np.asarray([codes.setdefault(x, len(codes)) for x in labels], np.int64)
    is_launch = np.asarray([x[3] in _LAUNCH_CALLS for x in calls], bool)
    dev_code = np.zeros(0, np.int64)
    dur = np.asarray([x[1] for x in device], np.float64)
    if len(device):
        corr = np.asarray([x[2] for x in calls], np.int64)
        order = np.argsort(corr, kind="stable")
        corr, by_corr = corr[order], call_code[order]
        want = np.asarray([x[0] for x in device], np.int64)
        pos = np.minimum(np.searchsorted(corr, want), max(corr.size - 1, 0))
        found = corr[pos] == want if corr.size else np.zeros(want.size, bool)
        orphan = codes.setdefault(None, len(codes)) if not found.all() else -1
        dev_code = np.where(found, by_corr[pos] if corr.size else orphan, orphan)
    n = np.bincount(call_code[is_launch], minlength=len(codes))
    t = np.bincount(dev_code, weights=dur, minlength=len(codes))
    return {label: {"launches": int(n[c]), "device": float(t[c])} for label, c in codes.items()}


def device_summary(path: str, top: int = 5, window_us: Optional[float] = None) -> dict:
    """Read a trace written by :func:`trace` (``path``: the file or its
    directory). Returns the device-busy share (the union of device
    activity intervals over ``window_us``, by default the span of every
    complete event in the trace), the number of kernels the device ran,
    the host's kernel and graph launch calls, the ``top`` device ops by
    total time, and ``by_span``: each innermost span's launch calls and
    the device time (µs) of what they launched (:func:`attribute`; the
    rest is outside every span)."""
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
    launches = [e for e in events if e.get("name") in _LAUNCH_CALLS]

    def corr(e) -> int:
        return int(e.get("args", {}).get("correlation", -1))

    def thread(e):
        return e.get("pid"), e.get("tid")

    by_span = attribute(
        [(thread(e), float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
         for e in events if e.get("cat") == "user_annotation"],
        [(thread(e), float(e["ts"]), corr(e), e["name"])
         for e in events if e.get("cat") in _CALL_CATS],
        [(corr(e), float(e.get("dur", 0.0))) for e in dev])
    return {
        "window_us": window_us,
        "device_busy_us": busy,
        "device_busy_share": busy / window_us if window_us > 0 else 0.0,
        "kernels": sum(1 for e in dev if e.get("cat") == "kernel"),
        "launch_calls": len(launches),
        "graph_launches": sum(1 for e in launches if e["name"] == "cudaGraphLaunch"),
        "top": [{"name": n, "total_us": v[0], "calls": v[1]} for n, v in ranked],
        "by_span": {k: {"launches": v["launches"], "device_us": v["device"]}
                    for k, v in by_span.items() if k is not None},
    }
