"""One run of the system under test: set-up, the measured window, the
reference, the verdict.

The window drives ``icpslam_tpu_torch.io.runner.run_slam`` over
``pipeline/slam.py::slam_step`` (chunk 1, the runner's prefetch depth of
3), the loop that users reach through ``python -m
icpslam_tpu_torch.io.runner``. The traffic is a closed loop: the cell's
sequence is replayed back to back, each replay on a fresh state, each
scan handed over as soon as the loop takes it, until the window ends; the
re-initialisation counts in the window. A scan completes when the
``post_step`` hook, which ``run_slam`` calls after every step, has
synchronized the current stream.

In a ``--trace 1`` run a second window follows the first under
``torch.profiler`` and the program's own tracing
(``icpslam_tpu_torch.utils.profiling.tracing``), with the benchmark's
spans around the named program functions (no synchronize), the K1/K2
calls' sizes recorded, and ``torch.cuda.set_sync_debug_mode("warn")``
counting the syncs PyTorch makes on its own, each tagged with the
innermost program span open on its thread when it is made. The spans and
the size records replace module attributes of the program; a traced run
stops, naming the attribute, where one is gone.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from icpslam_tpu_torch.config import from_dict
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.io import runner
from icpslam_tpu_torch.mapping import scan_to_map
from icpslam_tpu_torch.ops import nn as nn_ops
from icpslam_tpu_torch.pipeline import odometry, slam
from icpslam_tpu_torch.utils import profiling
from icpslam_tpu_torch.utils.logging import Logger
from yardstick import roofline, timeline, trace
from yardstick.context import RunContext
from yardstick.traffic import pad

# the benchmark's spans: name -> (module, function) wrapped in traced runs
SPANS = {
    "bench.step": (slam, "slam_step"),
    "bench.odometry": (odometry, "odometry_step"),
    "bench.scan_to_map": (scan_to_map, "refine_and_grow"),
    "bench.loop_closure": (slam, "_try_loop_closure"),
    "bench.optimize": (slam, "_optimize"),
}
# K1 and K2: the wrapper a traced run records each call's sizes around
KERNELS = {"k1": "nn1_cuda", "k2": "knn_cuda"}


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Window:
    """What the window produced, per scan in completion order."""
    start: float
    seconds: float
    completions: List[float]
    step_s: List[float]
    host_syncs: List[float]
    window_solves: List[float]
    optimized: List[float]
    replays: List[np.ndarray]           # each replay's (T, 18) records
    graphs: List[tuple]                 # (step, count, t, q): a replay's graph (:func:`run_window`)
    spans: Optional[Dict[str, List[float]]] = None
    implicit_syncs: Optional[List[float]] = None
    trace_events: Optional[list] = None
    kernel_calls: Optional[Dict[str, list]] = None
    program_spans: Optional[Dict[str, dict]] = None
    program_counts: Optional[Dict[str, Dict[str, List[float]]]] = None
    implicit_by_span: Optional[Dict[Optional[str], List[float]]] = None


def _source(scans: Sequence[np.ndarray], capacity: int, rate_hz: float,
            deadline: float = math.inf):
    """The runner's scan source: padded host scans with their stamps, as a
    sensor driver would hand them over, until ``deadline``."""
    for i, pts in enumerate(scans):
        if time.perf_counter() >= deadline:
            return
        yield pad(pts, capacity), i / rate_hz


def _pose(init, device) -> Pose:
    return Pose(t=torch.as_tensor(init[0], device=device), q=torch.as_tensor(init[1], device=device))


def warm(cfg, scans, init, rate_hz: float, device) -> float:
    """One replay of the sequence through ``run_slam`` on a throwaway
    state, before the window: the kernels' library loaded, the allocator
    filled, and whatever the program builds on a first call (the graph
    solves' captures, each bucket's at its first solve) built for every
    step a replay makes. Returns its seconds."""
    t0 = time.perf_counter()
    res = runner.run_slam(_source(scans, cfg.max_raw_points, rate_hz), cfg, _pose(init, device),
                          device, logger=Logger(level=0))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    rec = res.records
    log(f"warm: {len(rec)} scans, {int(rec[-1, 16]) if len(rec) else 0} keyframes, "
        f"{int(rec[:, 14].sum())} solves ({int(sum(res.window_solves))} window), "
        f"{int(rec[:, 13].sum())} loop closures, step ms max {max(res.step_ms, default=0.0):.2f}")
    return time.perf_counter() - t0


@contextlib.contextmanager
def _patched(patches):
    """Set module attributes for the block: [(module, name, value)]."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    try:
        for m, n, v in patches:
            setattr(m, n, v)
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def _span(name: str, fn: Callable, cur: Dict[str, float]):
    def wrapped(*args, **kw):
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                cur[name] += time.perf_counter() - t0
    return wrapped


def _kernel(orig: Callable, calls: list, knn: bool):
    """Record each call's query rows, live targets (a device count, read
    after the window) and k; keep the program's launch counters, which
    its body updates on the module's name, in step."""
    def wrapped(query, target, target_mask, *args, **kw):
        out = orig(query, target, target_mask, *args, **kw)
        orig.launches = wrapped.launches
        k = (args[0] if args else kw["k"]) if knn else 1
        if query.shape[0]:
            calls.append((int(query.shape[0]), target_mask.sum(), int(k)))
        return out
    wrapped.launches = orig.launches
    if hasattr(orig, "launches_by_capacity"):
        wrapped.launches_by_capacity = orig.launches_by_capacity
    return wrapped


def _implicit(records, marks: List[int]):
    """Per scan (``marks``: the warning count at each completion), the sync
    warnings that neither a counted host read (``utils/sync.py``) nor a
    stream or event synchronize made (``records``: (message, file, the
    innermost program span open when it was made)): in all, and by span."""
    own = ("icpslam_tpu_torch/utils/sync.py", "torch/cuda/streams.py")
    implicit = [(i, span) for i, (message, filename, span) in enumerate(records)
                if "synchronizing CUDA operation" in message
                and not filename.replace("\\", "/").endswith(own)]
    edges = np.asarray(marks, np.int64)

    def per_scan(rows) -> List[float]:
        counts = np.searchsorted(np.asarray(rows, np.int64), edges)
        return np.diff(np.concatenate([[0], counts])).astype(float).tolist()

    by_span = {span: per_scan([i for i, s in implicit if s == span])
               for span in {s for _, s in implicit}}
    return per_scan([i for i, _ in implicit]), by_span


def _append_replay(into: Dict[str, dict], replay: Dict[str, dict], offset: int) -> None:
    """Append one replay's per-scan lists (``replay``: name -> key -> list,
    or a span's "parent") to the window's (``into``), each list first
    filled with zeros up to ``offset``, the window's scans before the
    replay; :func:`_pad` evens them out at the end."""
    for name, by in replay.items():
        dst = into.setdefault(name, {})
        for key, v in by.items():
            if isinstance(v, list):
                got = dst.setdefault(key, [])
                got.extend([0.0] * (offset - len(got)))
                got.extend(v)
            else:
                dst[key] = v


def _pad(table: Dict[str, dict], n: int) -> Dict[str, dict]:
    """Fill each list of ``table`` with zeros up to ``n`` scans."""
    for by in table.values():
        for v in by.values():
            if isinstance(v, list):
                v.extend([0.0] * (n - len(v)))
    return table


def _graph(state) -> tuple:
    """A device copy of the state's keyframe count and graph poses."""
    kf = state.keyframes
    return kf.count.clone(), kf.pose_graph.t.clone(), kf.pose_graph.q.clone()


def _targets():
    """The program attributes a traced window replaces, each present."""
    targets = [(m, fn) for m, fn in SPANS.values()] + [(nn_ops, fn) for fn in KERNELS.values()]
    gone = [f"{m.__name__}.{fn}" for m, fn in targets if not hasattr(m, fn)]
    if gone:
        raise RuntimeError(f"the traced window wraps {', '.join(gone)}, which the program no "
                           "longer has: rename the span's target in benchmark/yardstick/drive.py")


def run_window(cfg, scans, init, rate_hz: float, seconds: float, device,
               traced: bool, snap_at: int) -> Window:
    """Replay the sequence back to back for ``seconds``; keep each
    replay's graph (keyframe count and poses) after its ``snap_at``-th
    step, or after its last where the window cut it short."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    completions: List[float] = []
    per: Dict[str, list] = {k: [] for k in ("step_s", "host_syncs", "window_solves", "optimized")}
    replays: List[np.ndarray] = []
    graphs: List[tuple] = []
    step_no = [0]
    cur = {name: 0.0 for name in SPANS}
    spans = {name: [] for name in SPANS}
    marks: List[int] = []
    recs: list = []
    calls = {key: [] for key in KERNELS}
    program_spans: Dict[str, dict] = {}
    program_counts: Dict[str, dict] = {}
    timing: Dict[str, float] = {}

    def show(message, category, filename, lineno, file=None, line=None):
        recs.append((str(message), filename, profiling.current()))

    def stop():
        t = time.perf_counter()
        prof.stop()
        timing["profiler_s"] = time.perf_counter() - t

    def hook(state, out):
        if cuda:
            torch.cuda.current_stream(dev).synchronize()
        completions.append(time.perf_counter())
        step_no[0] += 1
        if step_no[0] == snap_at:
            graphs.append((snap_at,) + _graph(state))
        if traced:
            for name in SPANS:
                spans[name].append(cur[name])
                cur[name] = 0.0
            marks.append(len(recs))
        return state

    patches = []
    if traced:
        _targets()
        patches = [(m, fn, _span(name, getattr(m, fn), cur)) for name, (m, fn) in SPANS.items()]
        patches += [(nn_ops, fn, _kernel(getattr(nn_ops, fn), calls[key], key == "k2"))
                    for key, fn in KERNELS.items()]
    quiet = Logger(level=0)
    prof = None
    with contextlib.ExitStack() as stack:
        stack.enter_context(_patched(patches))
        if traced:
            stack.enter_context(profiling.tracing())
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
                torch.cuda.set_sync_debug_mode("warn")
                stack.callback(torch.cuda.set_sync_debug_mode, 0)
            stack.enter_context(warnings.catch_warnings())
            warnings.simplefilter("always")
            # each warning with the span open on its thread as it is raised
            warnings.showwarning = show
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            stack.callback(stop)
            stack.enter_context(torch.profiler.record_function("bench.window"))
        start = time.perf_counter()
        deadline = start + seconds
        while time.perf_counter() < deadline:
            step_no[0] = 0
            res = runner.run_slam(_source(scans, cfg.max_raw_points, rate_hz, deadline), cfg,
                                  _pose(init, dev), dev, post_step=hook, chunk=1,
                                  logger=quiet, prefetch_depth=3)
            offset = len(per["step_s"])
            per["step_s"].extend(ms / 1000.0 for ms in res.step_ms)
            _append_replay(program_spans, res.spans, offset)
            _append_replay(program_counts, res.counts, offset)
            per["host_syncs"].extend(res.host_syncs)
            per["window_solves"].extend(res.window_solves)
            per["optimized"].extend(float(x) for x in res.records[:, 14])
            if 0 < step_no[0] < snap_at:
                graphs.append((step_no[0],) + _graph(res.state))
            replays.append(res.records)
            del res
    graphs = [(k, int(c), t[:int(c)].cpu().numpy(), q[:int(c)].cpu().numpy())
              for k, c, t, q in graphs]
    w = Window(start=start, seconds=seconds, completions=completions, replays=replays,
               graphs=graphs, **per)
    if traced:
        t0 = time.perf_counter()
        n = len(completions)
        w.spans = spans
        w.implicit_syncs, w.implicit_by_span = _implicit(recs, marks)
        w.program_spans = _pad(program_spans, n)
        w.program_counts = _pad(program_counts, n)
        names = profiling.snapshot()["parents"]
        w.trace_events = trace.events_from_profiler(prof, "bench.window", names) if prof else []
        w.kernel_calls = calls
        log(f"trace: {len(w.trace_events)} events read in {time.perf_counter() - t0:.2f} s "
            f"(reader); the profiler stopped in {timing.get('profiler_s', 0.0):.2f} s "
            f"(profiler); the window closed {t0 - deadline:.2f} s before")
    return w


def kernel_bounds(calls: Dict[str, list]) -> Dict[str, List[float]]:
    """Each recorded K1/K2 call's bound seconds (one read of the live
    counts)."""
    out = {}
    for key, rows in calls.items():
        if not rows:
            out[key] = []
            continue
        live = torch.stack([r[1] for r in rows]).cpu().numpy()
        if key == "k1":
            out[key] = [roofline.bound_seconds(roofline.k1_bytes(n, int(m)))
                        for (n, _, _), m in zip(rows, live)]
        else:
            out[key] = [roofline.bound_seconds(roofline.k2_bytes(n, int(m), k))
                        for (n, _, k), m in zip(rows, live)]
    return out


def context(w: Window, setup_s: float, profiled: Optional[Window] = None) -> RunContext:
    """The readers' view of a window; ``profiled``, the traced window that
    followed it."""
    summary = None
    if w.trace_events is not None:
        t0 = time.perf_counter()
        n = timeline.in_window(w.completions, w.start, w.seconds)
        # the device work of the window's scans: launched before the last completes
        until = w.completions[n - 1] - w.start if n else 0.0
        summary = trace.summarize(w.trace_events, w.seconds, kernel_bounds(w.kernel_calls),
                                  until=until)
        log(f"trace: summarized in {time.perf_counter() - t0:.2f} s (summary)")
    return RunContext(seconds=w.seconds, start=w.start, setup_s=setup_s,
                      completions=w.completions, step_s=w.step_s, host_syncs=w.host_syncs,
                      window_solves=w.window_solves, optimized=w.optimized,
                      implicit_syncs=w.implicit_syncs, spans=w.spans, trace=summary,
                      program_spans=w.program_spans, program_counts=w.program_counts,
                      implicit_by_span=w.implicit_by_span,
                      profiled=context(profiled, setup_s) if profiled is not None else None)


def config_of(config: dict):
    return from_dict(config["slam"])
