"""Reduce a profiler session to what the per-layer metrics read.

Events come in as ``(kind, name, start_s, end_s, thread, correlation)`` on
the window's clock (0 at the window's start); the last two may be left
off where they are not known:

- ``"device"``: a kernel, copy or memset on the card, with the
  correlation id of the host call that launched it;
- ``"span"``: a host span, the benchmark's (named ``bench.*``) or the
  program's (``icpslam_tpu_torch/utils/profiling.py``), with its thread;
- ``"call"``: a CUDA runtime or driver call on the host, with its thread
  and correlation id.

:func:`events_from_profiler` makes them from a ``torch.profiler`` session;
the rest is plain arithmetic and is tested on made-up timelines.

K1 and K2 launch a prologue (``stage_tiles``) before their search kernel
(``nn1_kernel``, ``knn_kernel``) on the same stream; a prologue's time
joins the next search kernel's call.
"""

from __future__ import annotations

import collections
import operator
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from yardstick import roofline, timeline
from yardstick.context import KernelShare, TraceSummary

Event = tuple  # (kind, name, start_s, end_s[, thread, correlation])

PROLOGUE = "stage_tiles"
SEARCH = {"k1": "nn1_kernel", "k2": "knn_kernel"}
# the host calls that launch work on the card: a kernel or a captured graph
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch")


def events_from_profiler(prof, origin: str, program: Iterable[str] = ()) -> List[Event]:
    """The device activity, the host spans and the CUDA runtime and driver
    calls of a stopped ``torch.profiler.profile``, in seconds from the
    start of the span named ``origin``. Spans are the benchmark's (named
    ``bench.*``) and those named in ``program``. Reads the raw events:
    building the profiler's own event objects takes minutes for a window.

    Device activity is every event on a CUDA device but the copies of the
    host annotations (``record_function``) that the profiler mirrors
    there, which carry the annotation's name. A call is a host event
    named ``cu*`` with a correlation id (the profiler's ``cuda_runtime``
    and ``cuda_driver`` activities; the host's ops, ``aten::*``, are
    skipped first)."""
    program = frozenset(program)
    spans, calls, device, annotations = [], [], [], set()
    origin_ns = None
    cuda = {}  # device type's value -> a CUDA device (its str() took most of the read)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith("aten::"):  # the host's ops, most of the events
            continue
        dt = e.device_type()
        on_device = cuda.get(dt.value)
        if on_device is None:
            on_device = cuda[dt.value] = "CUDA" in str(dt)
        if on_device:
            device.append((name, e.start_ns(), e.duration_ns(), e.correlation_id()))
        elif name.startswith("bench.") or name in program:
            annotations.add(name)
            a = e.start_ns()
            if name == origin and origin_ns is None:
                origin_ns = a
            spans.append((name, a, a + e.duration_ns(), e.start_thread_id()))
        elif e.is_user_annotation():
            annotations.add(name)
        elif name.startswith("cu"):
            corr = e.correlation_id()
            if corr:
                a = e.start_ns()
                calls.append((name, a, a + e.duration_ns(), e.start_thread_id(), corr))
    if origin_ns is None:
        raise RuntimeError(f"the trace holds no span {origin!r}")
    s = 1e-9
    out = [("device", n, (a - origin_ns) * s, (a + d - origin_ns) * s, None, c)
           for n, a, d, c in device if n not in annotations]
    out += [("span", n, (a - origin_ns) * s, (b - origin_ns) * s, t, None)
            for n, a, b, t in spans]
    out += [("call", n, (a - origin_ns) * s, (b - origin_ns) * s, t, c)
            for n, a, b, t, c in calls]
    return out


def _columns(rows: Sequence[Event], *fields: int) -> List[np.ndarray]:
    """Fields of the events as arrays: times (2, 3) as floats, threads and
    correlation ids (4, 5) as integers."""
    return [np.fromiter(map(operator.itemgetter(f), rows),
                        np.float64 if f in (2, 3) else np.int64, len(rows)) for f in fields]


def _codes(names: Sequence) -> Tuple[np.ndarray, list]:
    """Each name's index among the distinct names, in order of first
    appearance, and those names."""
    index = dict.fromkeys(names)
    for i, name in enumerate(index):
        index[name] = i
    return np.fromiter(map(index.__getitem__, names), np.int64, len(names)), list(index)


def search_calls(names: List[str], code: np.ndarray, start: np.ndarray,
                 end: np.ndarray) -> Dict[str, List[float]]:
    """Device seconds of each K1 and K2 call, in launch order, prologue
    included (``names[code[i]]``: device event i's name, which started at
    ``start[i]`` and ended at ``end[i]``)."""
    role = np.asarray([-1 if n.startswith(PROLOGUE) else
                       next((k for k, kernel in enumerate(SEARCH.values()) if kernel in n), -2)
                       for n in names] or [-2], np.int64)
    mine = np.flatnonzero(role[code] != -2) if code.size else np.zeros(0, np.int64)
    mine = mine[np.argsort(start[mine], kind="stable")]
    calls: Dict[str, List[float]] = {k: [] for k in SEARCH}
    keys = list(SEARCH)
    pending = 0.0
    for r, a, b in zip(role[code[mine]].tolist(), start[mine].tolist(), end[mine].tolist()):
        if r == -1:
            pending += b - a
        else:
            calls[keys[r]].append(pending + (b - a))
            pending = 0.0
    return calls


def kernel_share(device_s: Sequence[float], bound_s: Sequence[float]) -> Optional[KernelShare]:
    """The calls' bound and device seconds, when the trace holds as many
    calls as were recorded (else None: the two cannot be matched)."""
    if not device_s or len(device_s) != len(bound_s):
        return None
    return KernelShare(calls=len(device_s), bound_s=float(sum(bound_s)),
                       device_s=float(sum(device_s)))


def label_gaps(gaps: Sequence[Tuple[float, float]],
               spans: Sequence[Tuple[float, float, str]]) -> List[Optional[str]]:
    """Each gap's label: of the spans ``(start, end, name)`` that cover the
    gap's middle (``start <= middle <= end``), the one that starts last,
    the shorter first on equal starts; None where no span covers it.

    One sweep over the spans' starts and ends (the points) labels each
    point and each open stretch between two points: the spans in order of
    (start, longer first) are pushed on a stack as they start and popped
    from its top once they have ended, so the top is the latest-starting
    span open there, and a span popped has ended before every later
    point. Each middle then takes the label of the point it falls on, or
    of the stretch it falls in."""
    ranked = sorted(spans, key=lambda s: (s[0], -s[1]))
    points = np.unique(np.asarray([t for s in spans for t in s[:2]], np.float64))
    stack: List[Tuple[float, float, str]] = []
    nxt = 0
    labels: List[Optional[str]] = []  # point 0, stretch 0-1, point 1, ...
    p = points.tolist()
    for k, at in enumerate(p):
        while nxt < len(ranked) and ranked[nxt][0] <= at:
            stack.append(ranked[nxt])
            nxt += 1
        # the point itself, then the stretch up to the next point
        for keep_from in [at] + p[k + 1:k + 2]:
            while stack and stack[-1][1] < keep_from:
                stack.pop()
            labels.append(stack[-1][2] if stack else None)
    g = np.asarray(gaps, np.float64).reshape(-1, 2)
    mids = 0.5 * (g[:, 0] + g[:, 1])
    k = np.searchsorted(points, mids, side="left")
    on = (points[np.minimum(k, points.size - 1)] == mids) if points.size else np.zeros(k.size, bool)
    # before the first point, and after the last: no span
    slot = np.where(on, 2 * k + 1, 2 * k)
    table = np.asarray([None] + labels + [None], object)
    return table[slot].tolist()


def _innermost(spans: Sequence[Tuple[int, float, float, str]], threads: np.ndarray,
               times: np.ndarray, codes: Dict[Optional[str], int]) -> np.ndarray:
    """The code (``codes``, filled as names come) of the innermost of
    ``spans`` ((thread, start, end, name), nested on each thread) open at
    each (``threads[i]``, ``times[i]``); None's where none is."""
    none = codes.setdefault(None, len(codes))
    by_thread: Dict[int, list] = collections.defaultdict(list)
    for thread, a, b, name in spans:
        by_thread[thread].append((a, b, name))
    out = np.full(len(times), none, np.int64)
    for thread, items in by_thread.items():
        # the thread's timeline as segments [starts[i], starts[i + 1]) -> labels[i]
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
        code = np.asarray([codes.setdefault(x, len(codes)) for x in labels], np.int64)
        rows = np.flatnonzero(threads == thread)
        seg = np.searchsorted(np.asarray(starts, np.float64), times[rows], side="right") - 1
        out[rows] = np.where(seg >= 0, code[np.maximum(seg, 0)], none)
    return out


def attribute(spans: Sequence[Tuple[int, float, float, str]], thread: np.ndarray,
              time: np.ndarray, corr: np.ndarray, launch: np.ndarray, dev_corr: np.ndarray,
              dev_dur: np.ndarray) -> Dict[Optional[str], Tuple[int, float]]:
    """Launch calls and device time by the span that made them (the
    arithmetic of ``icpslam_tpu_torch.utils.profiling.attribute``, kept
    here so that the program cannot move the yardstick).

    ``spans``: (thread, start, end, name); the host's runtime and driver
    calls as columns: ``thread``, ``time``, correlation id ``corr``,
    whether it is a kernel or graph launch (``launch``); the kernels,
    copies and memsets as columns: ``dev_corr``, ``dev_dur``. A call
    belongs to the innermost span open on its own thread at its time, a
    device event to the span of its call. Returns ``{span: (kernel and
    graph launch calls, total device duration)}``; calls outside every
    span, and device events of no recorded call, under None."""
    codes: Dict[Optional[str], int] = {}
    call_code = _innermost(spans, thread, time, codes)
    order = np.argsort(corr, kind="stable")
    sorted_corr, by_corr = corr[order], call_code[order]
    pos = np.minimum(np.searchsorted(sorted_corr, dev_corr), max(sorted_corr.size - 1, 0))
    found = (sorted_corr[pos] == dev_corr) if sorted_corr.size else np.zeros(dev_corr.size, bool)
    dev_code = np.where(found, by_corr[pos] if sorted_corr.size else 0, codes[None])
    n = np.bincount(call_code[launch], minlength=len(codes))
    t = np.bincount(dev_code, weights=dev_dur, minlength=len(codes))
    return {label: (int(n[c]), float(t[c])) for label, c in codes.items()
            if n[c] or t[c] or label is not None}


def summarize(events: Sequence[Event], seconds: float,
              bound_s: Dict[str, Sequence[float]], top: int = 10,
              until: Optional[float] = None) -> TraceSummary:
    """Busy time and idle gaps inside ``[0, seconds]``, the costliest
    device ops there, K1's and K2's bound against their device time over
    every call of the session (``bound_s``: each call's bound, in launch
    order), and the launch calls and device seconds of the work launched
    in ``[0, until]`` (a call by its time, a device event of no recorded
    call by its start; all the window by default), by the innermost
    program span (not ``bench.*``) open on the calling thread."""
    dev = [e for e in events if e[0] == "device"]
    a, b = _columns(dev, 2, 3)
    busy_s, g0, g1 = timeline.union(a, b, 0.0, seconds)
    code, names = _codes(list(map(operator.itemgetter(1), dev)))
    inside = (b > 0.0) & (a < seconds)
    clipped = np.minimum(b[inside], seconds) - np.maximum(a[inside], 0.0)
    total = np.bincount(code[inside], weights=clipped, minlength=len(names))
    ops = sorted(((names[c], float(total[c])) for c in dict.fromkeys(code[inside].tolist())),
                 key=lambda kv: -kv[1])[:top]
    spans = [e for e in events if e[0] == "span"]
    labels = label_gaps(np.stack([g0, g1], axis=1), [(e[2], e[3], e[1]) for e in spans])
    label_code, label_names = _codes([x or "harness" for x in labels])
    idle_s = np.bincount(label_code, weights=g1 - g0, minlength=len(label_names))
    idle = sorted(zip(label_names, idle_s.tolist()), key=lambda kv: -kv[1])[:top]
    calls = search_calls(names, code, a, b)
    kernels = {}
    for key in SEARCH:
        share = kernel_share(calls[key], bound_s.get(key, ()))
        if share is not None:
            kernels[key] = share
    host = [e for e in events if e[0] == "call"]
    if not host:
        return TraceSummary(window_s=seconds, busy_s=busy_s, device_ops=ops, idle_gaps=idle,
                            kernels=kernels)
    time, = _columns(host, 2)
    thread, corr, dev_corr = *_columns(host, 4, 5), *_columns(dev, 5)
    launch = np.asarray([e[1] in LAUNCH_CALLS for e in host], bool)
    until = seconds if until is None else until
    # a device event is of the window's work when the call that launched it is
    order = np.argsort(corr, kind="stable")
    pos = np.minimum(np.searchsorted(corr[order], dev_corr), corr.size - 1)
    found = corr[order][pos] == dev_corr
    at = np.where(found, time[order][pos], a)
    mine, kept = (time >= 0.0) & (time <= until), (at >= 0.0) & (at <= until)
    program = [(e[4], e[2], e[3], e[1]) for e in spans if not e[1].startswith("bench.")]
    by_span = attribute(program, thread[mine], time[mine], corr[mine], launch[mine],
                        dev_corr[kept], (b - a)[kept])
    return TraceSummary(window_s=seconds, busy_s=busy_s, device_ops=ops, idle_gaps=idle,
                        kernels=kernels, by_span=by_span,
                        launch_calls=int(launch[(time >= 0.0) & (time <= seconds)].sum()))


def roofline_pct(summary: Optional[TraceSummary], key: str) -> Optional[float]:
    if summary is None or key not in summary.kernels:
        return None
    k = summary.kernels[key]
    return roofline.share_pct(k.bound_s, k.device_s)
