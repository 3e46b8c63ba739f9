"""The program's layers, as the per-layer readers roll its spans up.

A layer is named by its root spans. A span belongs to it when the span,
or one of its ancestors (the parent the program records for each span,
``RunResult.spans[name]["parent"]``), is a root:

- odometry: ``odometry.step``;
- scan-to-map: ``scan_to_map.refine``;
- back end: ``loop_closure.verify`` and ``graph.solve``.

What belongs to no layer (the step's own span, ``keyframes.add``, the
runner's spans, work outside every span) is "rest": :func:`rollup` gives
it beside the layers, so that their sum can be held to the window's
totals. Every number is per window scan of the profiled window.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

ODOMETRY = ("odometry.step",)
SCAN_TO_MAP = ("scan_to_map.refine",)
BACKEND = ("loop_closure.verify", "graph.solve")
LAYERS = {"odometry": ODOMETRY, "scan_to_map": SCAN_TO_MAP, "backend": BACKEND}


def in_layer(span: Optional[str], roots: Sequence[str], parents: Dict[str, Optional[str]]) -> bool:
    """Whether ``span`` or one of its ancestors is one of ``roots``."""
    seen = set()
    while span is not None and span not in seen:
        if span in roots:
            return True
        seen.add(span)
        span = parents.get(span)
    return False


def _parents(ctx) -> Dict[str, Optional[str]]:
    return {name: s.get("parent") for name, s in ctx.program_spans.items()}


def _ran(ctx, roots: Sequence[str]) -> bool:
    """A profiled window in which one of the layer's roots ran."""
    return (ctx is not None and ctx.program_spans is not None and ctx.n > 0
            and any(r in ctx.program_spans for r in roots))


def _over(table: Dict, member: Callable[[Optional[str]], bool], n: Optional[int] = None) -> float:
    """The sum over the spans of ``table`` that are ``member``s (span -> a
    number, or with ``n`` a per-scan list, of which the first ``n``)."""
    return sum((sum(v[:n]) if n is not None else v) for span, v in table.items()
               if span != "total" and member(span))


def _launched(ctx, member, field: int) -> float:
    return _over({s: v[field] for s, v in ctx.trace.by_span.items()}, member)


def _syncs(ctx, member) -> float:
    return (_over(ctx.program_counts.get("host_syncs", {}), member, ctx.n)
            + _over(ctx.implicit_by_span or {}, member, ctx.n))


def _member(ctx, roots: Sequence[str]) -> Callable[[Optional[str]], bool]:
    parents = _parents(ctx)
    return lambda span: in_layer(span, roots, parents)


def launches_per_scan(ctx, roots: Sequence[str]) -> Optional[float]:
    """Kernel and graph launch calls made inside the layer."""
    if not _ran(ctx, roots) or ctx.trace is None or not ctx.trace.by_span:
        return None
    return _launched(ctx, _member(ctx, roots), 0) / ctx.n


def device_ms_per_scan(ctx, roots: Sequence[str]) -> Optional[float]:
    """Device ms of the kernels, copies and memsets the layer launched."""
    if not _ran(ctx, roots) or ctx.trace is None or not ctx.trace.by_span:
        return None
    return 1000.0 * _launched(ctx, _member(ctx, roots), 1) / ctx.n


def count_per_scan(ctx, counter: str, roots: Sequence[str]) -> Optional[float]:
    """The program counter ``counter`` as counted inside the layer."""
    if not _ran(ctx, roots) or ctx.program_counts is None:
        return None
    return _over(ctx.program_counts.get(counter, {}), _member(ctx, roots), ctx.n) / ctx.n


def syncs_per_scan(ctx, roots: Sequence[str]) -> Optional[float]:
    """Host syncs inside the layer: its counted reads (``host_syncs``) and
    the implicit syncs tagged with its spans."""
    if not _ran(ctx, roots) or ctx.program_counts is None or ctx.implicit_by_span is None:
        return None
    return _syncs(ctx, _member(ctx, roots)) / ctx.n


def rollup(ctx) -> Optional[Dict[str, Dict[str, float]]]:
    """Launch calls, device ms and syncs per window scan of each layer, of
    the rest, and of the whole window: its kernel and graph launch calls,
    its busy time, its counted and implicit syncs."""
    if ctx is None or ctx.program_spans is None or ctx.trace is None or ctx.n == 0:
        return None
    members = {layer: _member(ctx, roots) for layer, roots in LAYERS.items()}
    layers = list(members.values())
    members["rest"] = lambda span: not any(m(span) for m in layers)
    n = ctx.n
    out = {name: {"launches": _launched(ctx, m, 0) / n,
                  "device_ms": 1000.0 * _launched(ctx, m, 1) / n,
                  "syncs": _syncs(ctx, m) / n} for name, m in members.items()}
    out["window"] = {
        "launches": ctx.trace.launch_calls / n,
        "device_ms": 1000.0 * ctx.trace.busy_s / n,
        "syncs": (sum(ctx.host_syncs[:n]) + sum((ctx.implicit_syncs or [])[:n])) / n,
    }
    return out
