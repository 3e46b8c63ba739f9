"""The window, trace and roofline arithmetic on made-up timelines."""

import numpy as np
import pytest

from yardstick import roofline, timeline, trace
from yardstick.context import RunContext
from yardstick.spec import _reader


def steady(n=400, dt=0.04, start=10.0):
    return [start + dt * (i + 1) for i in range(n)]


def ctx_of(completions, start=10.0, seconds=16.0, step_s=None, **kw):
    n = len(completions)
    return RunContext(seconds=seconds, start=start, setup_s=3.0, completions=completions,
                      step_s=step_s if step_s is not None else [0.03] * n,
                      host_syncs=[10.0] * n, window_solves=[0.0] * n, optimized=[0.0] * n, **kw)


def read(name, ctx):
    return _reader(name, timeline.__file__.rsplit("/yardstick/", 1)[0])(ctx)


def test_rate_and_tail_of_a_steady_window():
    c = steady()                    # 400 scans, one every 40 ms, window 16 s
    ctx = ctx_of(c)
    assert ctx.n == 400
    assert read("scans_per_s", ctx) == pytest.approx(25.0)
    assert read("scan_ms_p95.host", ctx) == pytest.approx(40.0)


def test_a_stall_inside_the_window_moves_rate_and_tail():
    """Stalls of 200 ms after every tenth scan: fewer scans complete in the
    window, and the 10% of scans that wait carry the tail."""
    c, t = [], 10.0
    for i in range(400):
        t += 0.04 + (0.2 if i % 10 == 9 else 0.0)
        c.append(t)
    base, stalled = ctx_of(steady()), ctx_of(c)
    assert read("scans_per_s", stalled) < 0.8 * read("scans_per_s", base)
    assert read("scan_ms_p95.host", stalled) == pytest.approx(240.0)
    assert read("scan_ms_p95.host", base) == pytest.approx(40.0)


def test_scans_past_the_window_and_the_first_scan_time():
    c = steady(n=500)              # 20 s of completions against a 16 s window
    ctx = ctx_of(c)
    assert ctx.n == 400
    times = timeline.scan_times(c, 10.0, 16.0)
    assert times.size == 400 and times[0] == pytest.approx(0.04)
    with pytest.raises(ValueError):
        timeline.in_window([9.0], 10.0, 1.0)


def test_host_gap_and_step_median():
    c = steady()
    ctx = ctx_of(c, step_s=[0.03] * 400)
    assert read("host_gap_ms_per_scan", ctx) == pytest.approx(10.0)
    assert read("step_ms_p50", ctx) == pytest.approx(30.0)


def test_union_of_busy_intervals_and_gaps():
    a, b = zip((0.5, 1.5), (1.0, 2.0), (3.0, 4.0), (9.5, 12.0))
    busy, g0, g1 = timeline.union(np.asarray(a), np.asarray(b), 0.0, 10.0)
    assert busy == pytest.approx(1.5 + 1.0 + 0.5)
    assert list(zip(g0.tolist(), g1.tolist())) == [(0.0, 0.5), (2.0, 3.0), (4.0, 9.5)]


def test_trace_summary_idle_share_and_kernel_calls():
    ev = [
        ("span", "bench.window", 0.0, 10.0),
        ("span", "bench.step", 1.0, 3.0),
        ("span", "bench.odometry", 1.0, 2.0),
        ("device", "stage_tiles", 1.00, 1.01),
        ("device", "void nn1_kernel(...)", 1.01, 1.03),
        ("device", "stage_tiles", 1.10, 1.12),
        ("device", "void knn_kernel<10>(...)", 1.12, 1.20),
        ("device", "elementwise", 2.5, 3.0),
        ("device", "void nn1_kernel(...)", 9.9, 10.1),   # runs over the window's end
    ]
    bound = {"k1": [0.001, 0.002], "k2": [0.004]}
    s = trace.summarize(ev, 10.0, bound)
    assert s.busy_s == pytest.approx(0.03 + 0.10 + 0.5 + 0.1)
    ctx = ctx_of(steady(), profiled=ctx_of(steady(), trace=s))
    assert read("device_idle_pct", ctx) == pytest.approx(100 * (1 - 0.73 / 10.0))
    # K1: the prologue joins the search kernel: (0.01 + 0.02) + 0.2 device seconds
    assert s.kernels["k1"].device_s == pytest.approx(0.23)
    assert read("k1_roofline", ctx) == pytest.approx(100 * 0.003 / 0.23)
    assert read("k2_roofline", ctx) == pytest.approx(100 * 0.004 / 0.10)
    gaps = dict(s.idle_gaps)
    # (1.03, 1.10) and (1.20, 2.5), whose middle lies in the odometry span
    assert gaps["bench.odometry"] == pytest.approx(0.07 + 1.30)
    assert gaps["bench.window"] == pytest.approx(1.0 + 6.9)
    assert "bench.step" not in gaps
    # recorded calls that the trace cannot match give no share, not 0
    s2 = trace.summarize(ev, 10.0, {"k1": [0.001], "k2": []})
    assert trace.roofline_pct(s2, "k1") is None and trace.roofline_pct(s2, "k2") is None


def test_readers_of_a_run_without_a_trace_return_nothing():
    ctx = ctx_of(steady())
    for name in ("device_idle_pct", "k1_roofline", "odometry_ms_per_scan",
                 "host_syncs_per_scan"):
        assert read(name, ctx) is None


def test_a_traced_run_reads_the_host_clock_from_its_untraced_window():
    """The tail and the step median come from the untraced window; the
    spans and syncs from the profiled one that follows it."""
    slow = steady(dt=0.08, n=200)
    profiled = ctx_of(slow, step_s=[0.07] * 200, implicit_syncs=[5.0] * 200,
                      spans={"bench.odometry": [0.03] * 200})
    ctx = ctx_of(steady(), profiled=profiled)
    assert read("scan_ms_p95.host", ctx) == pytest.approx(40.0)
    assert read("step_ms_p50", ctx) == pytest.approx(30.0)
    assert read("host_syncs_per_scan", ctx) == pytest.approx(15.0)
    assert read("odometry_ms_per_scan", ctx) == pytest.approx(30.0)


def test_kernel_bytes():
    # K1 on a scan: 8192 queries against 7,276 live targets
    assert roofline.k1_bytes(8192, 7276) == 12 * 8192 + 13 * 7276 + 8 * 8192
    assert roofline.k2_bytes(8192, 8192, 10) == 12 * 8192 + 13 * 8192 + 80 * 8192
    assert roofline.bound_seconds(3.35e12) == pytest.approx(1.0)
    assert roofline.share_pct(1.0, 0.0) is None


def test_percentile_matches_numpy():
    v = np.random.RandomState(0).exponential(size=333)
    assert timeline.percentile(v, 95) == pytest.approx(np.percentile(v, 95))

