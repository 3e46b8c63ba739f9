"""The traced window's reduction on made-up timelines: idle gaps labelled
in one sweep against the loop it replaced, the device-side copies of host
annotations kept out of device activity, and launch calls and device time
put on the program span that made them."""

import collections
import random

import numpy as np
import pytest

from yardstick import layers, timeline, trace
from yardstick.context import RunContext


def loop_labels(gaps, spans):
    """The label loop ``trace.summarize`` ran before the sweep: for each
    gap, every span from the start, in order of (start, longer first)."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        label = None
        for sa, sb, name in spans:
            if sa > mid:
                break
            if sb >= mid:
                label = name
        out.append(label)
    return out


NESTED = [(1.0, 9.0, "step"), (1.0, 4.0, "odometry"), (2.0, 3.0, "register"),
          (5.0, 8.0, "scan_to_map"), (5.0, 6.0, "insert")]
# a prefetch thread's spans overlap the main thread's without nesting in them
TWO_THREADS = NESTED + [(0.5, 1.5, "upload"), (3.5, 5.5, "upload"), (8.5, 12.0, "upload")]


@pytest.mark.parametrize("spans", [NESTED, TWO_THREADS], ids=["nested", "two_threads"])
def test_sweep_labels_gaps_as_the_loop_did(spans):
    gaps = [(0.0, 0.4), (0.8, 1.2), (1.9, 2.1), (2.5, 3.5), (3.9, 4.1), (4.5, 5.5),
            (5.9, 6.1), (8.8, 9.2), (9.5, 10.5), (12.5, 13.0)]
    got = trace.label_gaps(gaps, spans)
    assert got == loop_labels(gaps, spans)
    assert got[0] is None and got[-1] is None              # before the first span, after the last
    assert got[2] == "register"                              # the innermost of three
    assert trace.label_gaps([(4.9, 5.1)], NESTED) == ["insert"]  # equal starts: the shorter
    # a middle on a span's end or start is inside it
    on_edges = [(0.0, 4.0), (2.5, 3.5)]
    assert trace.label_gaps(on_edges, NESTED) == loop_labels(on_edges, NESTED) == [
        "register", "register"]


def test_sweep_labels_random_timelines_as_the_loop_did():
    rng = random.Random(5)
    for _ in range(200):
        spans = []
        for _ in range(rng.randrange(0, 30)):
            a = rng.choice([rng.uniform(0, 10), float(rng.randrange(0, 10))])
            spans.append((a, a + rng.choice([0.0, 1.0, rng.uniform(0, 4)]), f"s{len(spans)}"))
        ends = sorted(rng.uniform(0, 12) for _ in range(2 * rng.randrange(0, 20)))
        gaps = list(zip(ends[::2], ends[1::2]))
        rng.shuffle(gaps)
        assert trace.label_gaps(gaps, spans) == loop_labels(gaps, spans)


def test_summarize_labels_the_idle_time_by_the_innermost_span():
    ev = [("span", "bench.window", 0.0, 10.0), ("span", "odometry.step", 1.0, 4.0, 1),
          ("span", "odometry.register", 2.0, 3.0, 1), ("device", "k", 1.0, 2.0, None, 7),
          ("device", "k", 3.0, 5.0, None, 8)]
    s = trace.summarize(ev, 10.0, {})
    assert dict(s.idle_gaps) == pytest.approx({"bench.window": 1.0 + 5.0,
                                               "odometry.register": 1.0})
    assert s.busy_s == pytest.approx(3.0) and s.by_span == {} and s.launch_calls == 0


class _Type:
    def __init__(self, value, name):
        self.value, self.name = value, name

    def __str__(self):
        return f"DeviceType.{self.name}"


CPU, CUDA = _Type(0, "CPU"), _Type(1, "CUDA")


class _Event:
    """What ``torch.profiler`` hands over for one raw event (``kind``: the
    activity's type, which the reader does not see)."""

    def __init__(self, name, kind, start_us, dur_us, thread=1, corr=0, flagged=True):
        self._name, self._kind, self._thread, self._corr = name, kind, thread, corr
        self._start, self._dur = int(start_us * 1000), int(dur_us * 1000)
        self._flagged = flagged

    def name(self):
        return self._name

    def device_type(self):
        return CUDA if self._kind in ("kernel", "gpu_memcpy", "gpu_memset",
                                      "gpu_user_annotation") else CPU

    def is_user_annotation(self):
        return self._flagged and self._kind == "user_annotation"

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def correlation_id(self):
        # ops have sequence numbers there too
        return self._corr or 7

    def start_thread_id(self):
        return self._thread


def _session(flagged=True):
    """A window of 100 µs (starting at 10 µs): the main thread (1) in
    ``odometry.step`` ⊃ ``odometry.register``, then ``scan_to_map.refine``;
    the prefetch thread (2) uploading meanwhile; every annotation mirrored
    on the card."""
    E = lambda *a, **kw: _Event(*a, flagged=flagged, **kw)  # noqa: E731
    ev = [
        E("bench.window", "user_annotation", 10, 100),
        E("odometry.step", "user_annotation", 12, 40),
        E("odometry.register", "user_annotation", 20, 20),
        E("scan_to_map.refine", "user_annotation", 60, 30),
        E("runner.upload", "user_annotation", 15, 50, thread=2),
        E("aten::add", "cpu_op", 13, 1),
        E("torch.internal", "user_annotation", 13, 2),   # an annotation of no one's
        E("cudaLaunchKernel", "cuda_runtime", 13, 1, corr=101),           # odometry.step
        E("cudaLaunchKernel", "cuda_runtime", 25, 1, corr=102),           # odometry.register
        E("cudaMemcpyAsync", "cuda_runtime", 26, 1, corr=103),            # not a launch
        E("cudaMemcpyAsync", "cuda_runtime", 27, 1, thread=2, corr=104),  # the prefetch's
        E("cudaLaunchKernel", "cuda_runtime", 28, 1, thread=2, corr=105),
        E("cudaGraphLaunch", "cuda_runtime", 65, 1, corr=106),            # scan_to_map.refine
        E("cudaLaunchKernel", "cuda_runtime", 95, 1, corr=107),           # no span
        E("cudaLaunchKernel", "cuda_runtime", 105, 1, corr=108),          # after `until`
        E("elementwise", "kernel", 14, 2, corr=101),
        E("nn1_kernel", "kernel", 30, 4, corr=102),
        E("Memcpy HtoD", "gpu_memcpy", 31, 1, corr=103),
        E("Memcpy HtoD", "gpu_memcpy", 40, 3, corr=104),
        E("fill", "kernel", 44, 1, corr=105),
        E("captured_a", "kernel", 66, 2, corr=106),
        E("captured_b", "kernel", 68, 2, corr=106),
        E("tail", "kernel", 96, 1, corr=107),
        E("late", "kernel", 106, 1, corr=108),
    ]
    # the profiler's copies of the host annotations on the card's timeline
    ev += [E(e.name(), "gpu_user_annotation", e._start / 1000, e._dur / 1000)
           for e in ev if e._kind == "user_annotation"]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return ev
    return Prof()


PROGRAM = ["odometry.step", "odometry.register", "scan_to_map.refine", "runner.upload"]


@pytest.mark.parametrize("flagged", [True, False], ids=["flagged", "by_name"])
def test_events_leave_the_mirrors_out_of_device_activity(flagged):
    """Whether or not the profiler flags its host annotations, the copies
    of the spans' on the card are no device activity; another annotation's
    is, where it is not flagged."""
    ev = trace.events_from_profiler(_session(flagged), "bench.window", PROGRAM)
    kinds = collections.Counter(e[0] for e in ev)
    assert kinds == {"device": 9 + (not flagged), "span": 5, "call": 8}
    ev = [e for e in ev if e[1] != "torch.internal"]
    assert {e[1] for e in ev if e[0] == "span"} == {"bench.window", *PROGRAM}
    s = trace.summarize(ev, 1e-4, {})
    # the union of the 9 device events (a copy inside K1's time); no mirror counts
    assert s.busy_s == pytest.approx((2 + 4 + 3 + 1 + 4 + 1 + 1) * 1e-6)
    assert s.launch_calls == 6                  # 5 kernel launches and a graph launch
    first = [e for e in ev if e[0] == "call" and e[5] == 101][0]
    assert first[2] == pytest.approx(3e-6) and first[4] == 1


def test_launches_and_device_time_land_on_the_span_that_made_them():
    ev = trace.events_from_profiler(_session(), "bench.window", PROGRAM)
    # the work launched in the first 90 µs of the window
    got = trace.summarize(ev, 1e-4, {}, until=90e-6).by_span
    assert {k: n for k, (n, _) in got.items()} == {
        "odometry.step": 1, "odometry.register": 1, "runner.upload": 1,
        "scan_to_map.refine": 1, None: 1}
    assert {k: t * 1e6 for k, (_, t) in got.items()} == pytest.approx({
        "odometry.step": 2.0,
        "odometry.register": 4.0 + 1.0,   # its kernel, and the copy of its memcpy call
        "runner.upload": 3.0 + 1.0,       # the prefetch thread's calls, on its own span
        "scan_to_map.refine": 2.0 + 2.0,  # a graph launch: both of its kernels
        None: 1.0,                        # launched after every span had closed
    })
    # a device op of no recorded call goes to no span
    orphan = ev + [("device", "stray", 70e-6, 73e-6, None, 999)]
    assert trace.summarize(orphan, 1e-4, {}, until=90e-6).by_span[None][1] == pytest.approx(4e-6)


def _read(name, ctx):
    from yardstick.spec import BENCH_DIR, _reader
    return _reader(name, BENCH_DIR)(ctx)


def test_layers_roll_the_spans_up_and_add_up_to_the_window():
    """Two scans: each span under its layer's root by the parents the
    program recorded; what is in no layer is the rest, and layers and rest
    sum to the window's launch calls, device time and syncs."""
    ev = trace.events_from_profiler(_session(), "bench.window", PROGRAM)
    s = trace.summarize(ev, 1e-4, {}, until=90e-6)
    ms = {"total": [1.0, 1.0], "self": [0.5, 0.5]}
    spans = {"slam.step": dict(ms, parent=None), "odometry.step": dict(ms, parent="slam.step"),
             "odometry.register": dict(ms, parent="odometry.step"),
             "scan_to_map.refine": dict(ms, parent="slam.step"),
             "graph.solve": dict(ms, parent="slam.step"), "runner.upload": dict(ms, parent=None)}
    counts = {"host_syncs": {"total": [5.0, 7.0], "odometry.register": [2.0, 2.0],
                             "scan_to_map.refine": [1.0, 3.0], "graph.solve": [0.0, 1.0],
                             "slam.step": [2.0, 1.0]},
              "icp.iterations": {"total": [9.0, 11.0], "odometry.register": [4.0, 5.0],
                                 "scan_to_map.register": [5.0, 6.0]}}
    implicit = {"odometry.step": [1.0, 0.0], None: [2.0, 2.0], "graph.solve": [0.0, 1.0]}
    prof = RunContext(seconds=1e-4, start=0.0, setup_s=1.0, completions=[40e-6, 90e-6],
                      step_s=[0.04, 0.05], host_syncs=[5.0, 7.0], window_solves=[0.0, 0.0],
                      optimized=[0.0, 0.0], implicit_syncs=[3.0, 3.0], trace=s,
                      program_spans=spans, program_counts=counts, implicit_by_span=implicit)
    ctx = RunContext(seconds=1.0, start=0.0, setup_s=1.0, completions=[0.5], step_s=[0.4],
                     host_syncs=[0.0], window_solves=[0.0], optimized=[0.0], profiled=prof)
    assert prof.n == 2
    assert _read("odometry_launches_per_scan", ctx) == pytest.approx(2 / 2)
    assert _read("odometry_device_ms_per_scan", ctx) == pytest.approx(7e-3 / 2)
    assert _read("scan_to_map_launches_per_scan", ctx) == pytest.approx(1 / 2)
    assert _read("odometry_syncs_per_scan", ctx) == pytest.approx((4 + 1) / 2)
    assert _read("scan_to_map_syncs_per_scan", ctx) == pytest.approx(4 / 2)
    assert _read("backend_syncs_per_scan", ctx) == pytest.approx(2 / 2)
    assert _read("backend_launches_per_scan", ctx) == 0.0   # graph.solve ran, launched nothing
    assert _read("odometry_iterations_per_scan", ctx) == pytest.approx(9 / 2)
    # scan_to_map.register closed in no scan of this window: its parent is not known
    assert _read("scan_to_map_iterations_per_scan", ctx) == 0.0
    got = layers.rollup(prof)
    parts = {what: sum(v[what] for k, v in got.items() if k != "window")
             for what in ("launches", "device_ms", "syncs")}
    assert parts["syncs"] == got["window"]["syncs"] == (12 + 6) / 2
    assert parts["launches"] == pytest.approx(5 / 2)
    assert parts["device_ms"] == pytest.approx((2 + 5 + 4 + 4 + 1) * 1e-3 / 2)
    assert got["rest"]["syncs"] == pytest.approx((3 + 4) / 2)
    assert got["rest"]["launches"] == pytest.approx((1 + 1) / 2)   # the prefetch's, the tail's
    assert got["window"]["launches"] == pytest.approx(6 / 2)       # and one after the last scan
    # a layer whose root never ran reads nothing, as does an untraced run
    del spans["graph.solve"]
    assert _read("backend_launches_per_scan", ctx) is None
    for name in ("odometry_launches_per_scan", "odometry_syncs_per_scan",
                 "odometry_iterations_per_scan", "odometry_device_ms_per_scan"):
        assert _read(name, RunContext(seconds=1.0, start=0.0, setup_s=1.0, completions=[0.5],
                                      step_s=[0.4], host_syncs=[0.0], window_solves=[0.0],
                                      optimized=[0.0])) is None


def loop_busy(intervals, lo, hi):
    """The union's length as ``trace.summarize``'s loop took it before the
    arrays' pass."""
    spans = sorted((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi)
    total, end = 0.0, lo
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def loop_gaps(intervals, lo, hi):
    """The idle gaps as the loop found them before the arrays' pass."""
    spans = sorted((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi)
    out, end = [], lo
    for a, b in spans:
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if hi > end:
        out.append((end, hi))
    return out



def test_union_is_busy_and_gaps_to_the_last_bit():
    """The arrays' pass gives what the loops gave, bit for bit, on made-up
    intervals: overlapping, nested, empty, touching, outside the window."""
    rng = np.random.RandomState(3)
    for _ in range(300):
        n = rng.randint(0, 60)
        a = np.where(rng.rand(n) < 0.3, rng.randint(0, 10, n), rng.uniform(-1, 11, n))
        b = a + np.where(rng.rand(n) < 0.2, 0.0, rng.exponential(1.0, n))
        iv = list(zip(a.tolist(), b.tolist()))
        busy, g0, g1 = timeline.union(a, b, 0.0, 10.0)
        assert busy == loop_busy(iv, 0.0, 10.0)
        assert list(zip(g0.tolist(), g1.tolist())) == loop_gaps(iv, 0.0, 10.0)


def loop_summary(events, seconds, top=10):
    """``trace.summarize``'s busy time, costliest ops, idle gaps by span and
    K1 / K2 calls as its loops made them before the arrays' pass."""
    dev = [(a, b) for kind, _, a, b, *_ in events if kind == "device"]
    by_op = collections.Counter()
    for kind, name, a, b, *_ in events:
        if kind == "device" and b > 0.0 and a < seconds:
            by_op[name] += min(b, seconds) - max(a, 0.0)
    gaps = loop_gaps(dev, 0.0, seconds)
    spans = [(a, b, name) for kind, name, a, b, *_ in events if kind == "span"]
    by_host = collections.Counter()
    for (a, b), label in zip(gaps, loop_labels(gaps, spans)):
        by_host[label or "harness"] += b - a
    calls, pending = {k: [] for k in trace.SEARCH}, 0.0
    for kind, name, a, b, *_ in sorted((e for e in events if e[0] == "device"),
                                       key=lambda e: e[2]):
        if name.startswith(trace.PROLOGUE):
            pending += b - a
            continue
        for key, kernel in trace.SEARCH.items():
            if kernel in name:
                calls[key].append(pending + (b - a))
                pending = 0.0
                break
    return (loop_busy(dev, 0.0, seconds), sorted(by_op.items(), key=lambda kv: -kv[1])[:top],
            sorted(by_host.items(), key=lambda kv: -kv[1])[:top], calls)


def test_summary_reads_as_its_loops_did():
    rng = random.Random(11)
    names = ["stage_tiles", "void nn1_kernel(...)", "void knn_kernel<10>(...)", "add", "mul",
             "Memcpy HtoD"]
    for _ in range(50):
        ev = [("span", "bench.window", 0.0, 10.0)]
        for _ in range(rng.randrange(0, 15)):
            a = rng.uniform(-1, 10)
            ev.append(("span", rng.choice(["bench.step", "odometry.step", "slam.step"]), a,
                       a + rng.uniform(0, 3), rng.choice([1, 2])))
        for i in range(rng.randrange(0, 300)):
            a = rng.choice([rng.uniform(-0.5, 10.5), float(rng.randrange(0, 10))])
            ev.append(("device", rng.choice(names), a, a + rng.expovariate(20), None, i))
        rng.shuffle(ev)
        busy, ops, idle, calls = loop_summary(ev, 10.0)
        bounds = {k: [1e-3] * len(v) for k, v in calls.items()}
        s = trace.summarize(ev, 10.0, bounds)
        assert (s.busy_s, s.device_ops, s.idle_gaps) == (busy, ops, idle)
        assert {k: (v.calls, v.device_s) for k, v in s.kernels.items()} == {
            k: (len(v), float(sum(v))) for k, v in calls.items() if v}
