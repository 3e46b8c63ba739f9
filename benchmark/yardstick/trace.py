"""Reduce a profiler session to what the per-layer metrics read.

Events come in as ``(kind, name, start_s, end_s)`` on the window's clock
(0 at the window's start): ``kind`` is ``"device"`` (a kernel, copy or
memset on the card) or ``"span"`` (a host span the benchmark recorded).
:func:`events_from_profiler` makes them from a ``torch.profiler`` session;
the rest is plain arithmetic and is tested on made-up timelines.

K1 and K2 launch a prologue (``stage_tiles``) before their search kernel
(``nn1_kernel``, ``knn_kernel``) on the same stream; a prologue's time
joins the next search kernel's call.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

from yardstick import roofline, timeline
from yardstick.context import KernelShare, TraceSummary

Event = Tuple[str, str, float, float]

PROLOGUE = "stage_tiles"
SEARCH = {"k1": "nn1_kernel", "k2": "knn_kernel"}


def _ns(e, what: str) -> int:
    """An event's start or duration in ns (``start_ns`` / ``duration_ns``,
    or the microsecond accessors of older releases)."""
    fn = getattr(e, f"{what}_ns", None)
    return int(fn()) if fn is not None else int(getattr(e, f"{what}_us")() * 1000)


def events_from_profiler(prof, origin: str) -> List[Event]:
    """The device activity and the benchmark's spans (named ``bench.*``)
    of a stopped ``torch.profiler.profile``, in seconds from the start of
    the span named ``origin``. Reads the raw events: building the
    profiler's own event objects takes minutes for a window. Device
    activity is every event on a CUDA device but the copies of the host
    spans that the profiler mirrors there."""
    raw, origin_ns = [], None
    cuda = {}  # device type's value -> a CUDA device (its str() took most of the read)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        dt = e.device_type()
        on_device = cuda.get(dt.value)
        if on_device is None:
            on_device = cuda[dt.value] = "CUDA" in str(dt)
        if name.startswith("bench."):
            if on_device:
                continue
            kind = "span"
        elif on_device:
            kind = "device"
        else:
            continue
        a = _ns(e, "start")
        if kind == "span" and name == origin and origin_ns is None:
            origin_ns = a
        raw.append((kind, name, a, a + _ns(e, "duration")))
    if origin_ns is None:
        raise RuntimeError(f"the trace holds no span {origin!r}")
    return [(k, n, (a - origin_ns) * 1e-9, (b - origin_ns) * 1e-9) for k, n, a, b in raw]


def search_calls(events: Sequence[Event]) -> Dict[str, List[float]]:
    """Device seconds of each K1 and K2 call, in launch order, prologue
    included."""
    calls: Dict[str, List[float]] = {k: [] for k in SEARCH}
    pending = 0.0
    for kind, name, a, b in sorted((e for e in events if e[0] == "device"), key=lambda e: e[2]):
        if name.startswith(PROLOGUE):
            pending += b - a
            continue
        for key, kernel in SEARCH.items():
            if kernel in name:
                calls[key].append(pending + (b - a))
                pending = 0.0
                break
    return calls


def kernel_share(device_s: Sequence[float], bound_s: Sequence[float]) -> Optional[KernelShare]:
    """The calls' bound and device seconds, when the trace holds as many
    calls as were recorded (else None: the two cannot be matched)."""
    if not device_s or len(device_s) != len(bound_s):
        return None
    return KernelShare(calls=len(device_s), bound_s=float(sum(bound_s)),
                       device_s=float(sum(device_s)))


def summarize(events: Sequence[Event], seconds: float,
              bound_s: Dict[str, Sequence[float]], top: int = 10) -> TraceSummary:
    """Busy time and idle gaps inside ``[0, seconds]``, the costliest
    device ops there, and K1's and K2's bound against their device time
    over every call of the session (``bound_s``: each call's bound, in
    launch order)."""
    dev = [(a, b) for kind, _, a, b in events if kind == "device"]
    busy_s = timeline.busy(dev, 0.0, seconds)
    by_op: Dict[str, float] = collections.Counter()
    for kind, name, a, b in events:
        if kind == "device" and b > 0.0 and a < seconds:
            by_op[name] += min(b, seconds) - max(a, 0.0)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    # by start, the longer first: the last span that covers a point is the innermost
    spans = sorted(((a, b, name) for kind, name, a, b in events if kind == "span"),
                   key=lambda s: (s[0], -s[1]))
    by_host: Dict[str, float] = collections.Counter()
    for a, b in timeline.gaps(dev, 0.0, seconds):
        mid = 0.5 * (a + b)
        # the innermost (latest-starting) span that covers the gap's middle
        label = "harness"
        for sa, sb, name in spans:
            if sa > mid:
                break
            if sb >= mid:
                label = name
        by_host[label] += b - a
    gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    calls = search_calls(events)
    kernels = {}
    for key in SEARCH:
        share = kernel_share(calls[key], bound_s.get(key, ()))
        if share is not None:
            kernels[key] = share
    return TraceSummary(window_s=seconds, busy_s=busy_s, device_ops=ops, idle_gaps=gaps,
                        kernels=kernels)


def roofline_pct(summary: Optional[TraceSummary], key: str) -> Optional[float]:
    if summary is None or key not in summary.kernels:
        return None
    k = summary.kernels[key]
    return roofline.share_pct(k.bound_s, k.device_s)
