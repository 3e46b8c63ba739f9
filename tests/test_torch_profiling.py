"""The port's tracing (``icpslam_tpu_torch/utils/profiling.py``) on the CPU.

- the span registry: the off path records nothing and opens no
  ``record_function``; nesting, self time, the innermost span per thread,
  counters by span, ``paused()`` (registered call counters restored), the
  snapshot differences;
- the launch and device-time attribution on made-up timelines (a launch
  from the prefetch thread stays off the main thread's spans), and
  ``device_summary`` on a made-up Chrome trace;
- a 6-scan ``run_slam`` at ``tiny_config()`` size with tracing on against
  the same run with it off: records bit-equal, the per-scan host syncs by
  span summing to ``RunResult.host_syncs``, child spans within their
  parents, the GN iterations and loop-closure counts by span against the
  per-scan records;
- ``profiling.trace()`` writing a trace that holds the program's spans,
  read back by ``device_summary``.
"""

import torch

# one intra-op thread per test worker: the suite runs several pytest
# workers on the host's cores beside XLA's own pool
torch.set_num_threads(1)

import json
import threading
import time

import numpy as np
import pytest

from icpslam_tpu_torch.config import tiny_config
from icpslam_tpu_torch.graph import pose_graph as tpg
from icpslam_tpu_torch.io import runner
from icpslam_tpu_torch.io import synthetic as tsyn
from icpslam_tpu_torch.utils import profiling as tprof

N_SCANS = 6
# the packed record's columns (pipeline/slam.py)
ITERATIONS, LOOP = 10, 13


def _no_record_function(name):
    raise AssertionError(f"record_function({name!r}) opened with tracing off")


def test_off_path_records_nothing_and_opens_no_record_function(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _no_record_function)
    assert not tprof.enabled()
    before = tprof.snapshot()

    @tprof.spanned("test.off_fn")
    def fn(x):
        return x + 1

    with tprof.annotate("test.off"):
        assert tprof.current() is None
        tprof.count("test.off_counter", 3)
        assert fn(1) == 2
    assert tprof.annotate("test.a") is tprof.annotate("test.b")  # one shared no-op
    d = tprof.delta(before, tprof.snapshot())
    assert d["counts"] == {"test.off_counter": 3}   # counters count always
    assert d["spans"] == {} and d["by_span"] == {}


def test_spans_nest_with_self_time():
    before = tprof.snapshot()
    with tprof.tracing():
        with tprof.annotate("test.outer"):
            time.sleep(0.002)
            with tprof.annotate("test.inner"):
                time.sleep(0.003)
            with tprof.annotate("test.inner"):
                pass
    after = tprof.snapshot()
    d = tprof.delta(before, after)["spans"]
    calls_o, total_o, self_o = d["test.outer"]
    calls_i, total_i, self_i = d["test.inner"]
    assert (calls_o, calls_i) == (1, 2)
    assert total_i >= 3e6 and self_i == total_i
    assert self_o == total_o - total_i >= 2e6
    assert after["parents"]["test.inner"] == "test.outer"
    assert after["parents"]["test.outer"] is None


def test_current_is_the_innermost_span_of_the_calling_thread():
    seen = {}

    def other():
        seen["before"] = tprof.current()
        with tprof.annotate("test.thread"):
            seen["inside"] = tprof.current()

    with tprof.tracing():
        with tprof.annotate("test.main"):
            with tprof.annotate("test.main_inner"):
                t = threading.Thread(target=other)
                t.start()
                t.join()
                assert tprof.current() == "test.main_inner"
            assert tprof.current() == "test.main"
    assert tprof.current() is None
    assert seen == {"before": None, "inside": "test.thread"}


def test_counters_by_innermost_span_while_tracing():
    before = tprof.snapshot()
    tprof.count("test.c")                       # off: the total only
    with tprof.tracing():
        tprof.count("test.c", 2)                # outside every span
        with tprof.annotate("test.layer"):
            tprof.count("test.c", 4)
            with tprof.annotate("test.sub"):
                tprof.count("test.c", 8)
    d = tprof.delta(before, tprof.snapshot())
    assert d["counts"]["test.c"] == 15
    assert d["by_span"] == {(None, "test.c"): 2, ("test.layer", "test.c"): 4,
                            ("test.sub", "test.c"): 8}


def test_paused_counts_nothing_and_restores_registered_counters():
    before = tprof.snapshot()
    calls = tpg.optimize_window.calls
    assert before["counts"]["graph.window_solves"] == calls
    with tprof.tracing(), tprof.paused():
        tprof.count("test.paused")
        tpg.optimize_window.calls += 5        # a capture running the solve's body
        with tprof.paused():
            tprof.count("test.paused")
    assert tpg.optimize_window.calls == calls
    tpg.optimize_window.calls += 1            # a replay counts
    d = tprof.delta(before, tprof.snapshot())
    tpg.optimize_window.calls -= 1
    assert d["counts"] == {"graph.window_solves": 1}
    assert d["by_span"] == {}


def test_tracing_restores_the_switch_and_a_raising_span_closes():
    @tprof.spanned("test.raises")
    def boom():
        """Raises."""
        raise ValueError("boom")

    assert boom.__name__ == "boom" and boom.__doc__ == "Raises."
    before = tprof.snapshot()
    with tprof.tracing():
        with tprof.tracing(False):
            assert not tprof.enabled()
        assert tprof.enabled()
        with pytest.raises(ValueError):
            boom()
        assert tprof.current() is None
    assert not tprof.enabled()
    assert tprof.delta(before, tprof.snapshot())["spans"]["test.raises"][0] == 1


# a made-up timeline (µs): the main thread steps, the prefetch thread
# uploads a scan during the main thread's odometry
SPANS = [("main", 0.0, 100.0, "slam.step"), ("main", 10.0, 50.0, "odometry.step"),
         ("main", 20.0, 30.0, "odometry.filter"), ("main", 60.0, 70.0, "scan_to_map.refine"),
         ("prefetch", 22.0, 32.0, "runner.upload")]
CALLS = [
    ("main", 5.0, 1, "cudaLaunchKernel"),         # the step's own
    ("main", 12.0, 2, "cudaLaunchKernel"),        # odometry
    ("main", 25.0, 3, "cudaLaunchKernel"),        # the filter
    ("prefetch", 24.0, 4, "cudaMemcpyAsync"),     # the upload: a copy, not a launch
    ("prefetch", 26.0, 5, "cudaLaunchKernel"),    # during odometry, on another thread
    ("main", 65.0, 6, "cudaGraphLaunch"),         # scan-to-map
    ("main", 110.0, 7, "cudaLaunchKernel"),       # after the step
]
DEVICE = [(1, 1.0), (2, 2.0), (3, 4.0), (4, 8.0), (5, 16.0), (6, 32.0), (6, 32.0), (7, 64.0),
          (99, 128.0)]                            # 99: no recorded call


def test_innermost_span_per_thread():
    threads = ["main", "main", "main", "main", "main", "prefetch", "prefetch", "other"]
    times = [-1.0, 5.0, 25.0, 30.0, 40.0, 25.0, 40.0, 25.0]
    assert tprof._innermost(SPANS, threads, times) == [
        None, "slam.step", "odometry.filter", "odometry.step", "odometry.step",
        "runner.upload", None, None]


def test_launches_and_device_time_by_the_span_that_made_them():
    got = tprof.attribute(SPANS, CALLS, DEVICE)
    assert got == {
        "slam.step": {"launches": 1, "device": 1.0},
        "odometry.step": {"launches": 1, "device": 2.0},
        "odometry.filter": {"launches": 1, "device": 4.0},
        "runner.upload": {"launches": 1, "device": 24.0},
        "scan_to_map.refine": {"launches": 1, "device": 64.0},
        None: {"launches": 1, "device": 192.0},
    }
    assert sum(v["launches"] for v in got.values()) == 6   # the memcpy is no launch
    assert sum(v["device"] for v in got.values()) == sum(d for _, d in DEVICE)
    assert tprof.attribute([], [], []) == {}


def test_device_summary_by_span(tmp_path):
    def x(cat, name, ts, dur, tid=1, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    ids = {"main": 1, "prefetch": 2}
    events = [x("user_annotation", n, a, b - a, ids[th]) for th, a, b, n in SPANS]
    events += [x("cuda_runtime", n, t, 0.5, ids[th], c) for th, t, c, n in CALLS]
    events += [x("kernel" if c != 4 else "gpu_memcpy", f"k{c}", 200.0 + c, d, 9, c)
               for c, d in DEVICE]
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": events}))
    s = tprof.device_summary(str(tmp_path / "t.json"))
    assert s["launch_calls"] == 6 and s["graph_launches"] == 1 and s["kernels"] == 8
    assert s["by_span"] == {
        "slam.step": {"launches": 1, "device_us": 1.0},
        "odometry.step": {"launches": 1, "device_us": 2.0},
        "odometry.filter": {"launches": 1, "device_us": 4.0},
        "runner.upload": {"launches": 1, "device_us": 24.0},
        "scan_to_map.refine": {"launches": 1, "device_us": 64.0},
    }


def _config():
    return tiny_config(voxel_leaf_size=0.3, keyframe_distance=0.3, keyframes_window=2)


def _scans(n=N_SCANS):
    cfg = _config()
    t, q = tsyn.make_loop_trajectory(n_poses=40, radius=3.0)
    return list(tsyn.scan_stream(tsyn.make_room_world(seed=0), (t[:n], q[:n]),
                                 cfg.max_raw_points, n_points=900, rate_hz=10.0))


@pytest.fixture(scope="module")
def runs():
    cfg, scans = _config(), _scans()
    off = runner.run_slam(scans, cfg, device="cpu")
    with tprof.tracing():
        on = runner.run_slam(scans, cfg, device="cpu")
    return off, on


def test_tracing_leaves_the_records_bit_equal(runs):
    off, on = runs
    np.testing.assert_array_equal(off.records, on.records)
    assert off.host_syncs == on.host_syncs and off.window_solves == on.window_solves
    assert off.records[:, LOOP].sum() >= 1    # the drive closes a loop


def test_tracing_off_leaves_spans_and_counts_empty(runs):
    off, _ = runs
    assert off.spans == {} and off.counts == {}
    s = off.summary()
    assert "span_ms_per_scan" not in s and "counts_per_scan" not in s


def test_host_syncs_by_span_sum_to_the_runs(runs):
    _, on = runs
    by = on.counts["host_syncs"]
    assert by["total"] == on.host_syncs
    assert len(by) > 3
    per_scan = np.sum([v for k, v in by.items() if k != "total"], axis=0)
    np.testing.assert_allclose(per_scan, on.host_syncs)
    assert by["loop_closure.verify"][-1] > 0 and by["odometry.register"][1] > 0


def test_child_spans_lie_within_their_parents(runs):
    _, on = runs
    names = {"slam.step", "odometry.step", "odometry.filter", "odometry.register",
             "scan_to_map.refine", "scan_to_map.register", "scan_to_map.insert",
             "keyframes.add", "loop_closure.verify", "graph.solve", "runner.upload"}
    assert names <= set(on.spans)
    for name, s in on.spans.items():
        total, own = np.asarray(s["total"]), np.asarray(s["self"])
        assert len(total) == N_SCANS
        assert (own >= 0).all() and (own <= total).all(), name
        if s["parent"] is not None:
            assert (total <= np.asarray(on.spans[s["parent"]]["total"])).all(), name
    assert on.spans["odometry.register"]["parent"] == "odometry.step"
    assert on.spans["odometry.step"]["parent"] == "slam.step"
    assert on.spans["runner.upload"]["parent"] is None
    # the step's time holds the step span's
    assert (np.asarray(on.spans["slam.step"]["total"]) <= np.asarray(on.step_ms)).all()


def test_iterations_and_loop_closures_counted_by_layer(runs):
    _, on = runs
    iters = on.counts["icp.iterations"]
    np.testing.assert_array_equal(iters["odometry.register"], on.records[:, ITERATIONS])
    assert sum(iters["scan_to_map.register"]) > 0
    layers = {k for k in iters if k != "total"}
    assert layers <= {"odometry.register", "scan_to_map.register", "loop_closure.verify"}
    np.testing.assert_allclose(np.sum([iters[k] for k in layers], axis=0), iters["total"])
    accepted = on.counts["loop_closure.accepted"]["loop_closure.verify"]
    np.testing.assert_array_equal(accepted, on.records[:, LOOP])
    candidates = on.counts["loop_closure.candidates"]["total"]
    assert (np.asarray(candidates) >= np.asarray(accepted)).all()


def test_summary_reports_spans_and_counts(runs):
    _, on = runs
    s = on.summary()
    step = s["span_ms_per_scan"]["slam.step"]
    assert step["total"] == pytest.approx(np.mean(on.spans["slam.step"]["total"]))
    assert step["parent"] is None and 0 <= step["self"] <= step["total"]
    c = s["counts_per_scan"]["host_syncs"]
    assert c["total"] == pytest.approx(s["host_syncs_per_scan"])
    json.dumps(s)


def test_trace_holds_the_program_spans(tmp_path):
    cfg = _config()
    with tprof.trace(str(tmp_path)):
        res = runner.run_slam(_scans(4), cfg, device="cpu")
    assert not tprof.enabled()
    events = json.loads((tmp_path / tprof.TRACE_FILE).read_text())["traceEvents"]
    names = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    assert {"slam.step", "odometry.step", "odometry.filter", "odometry.register",
            "scan_to_map.refine", "scan_to_map.register", "scan_to_map.insert",
            "keyframes.add", "graph.solve"} <= names
    # the prefetch thread's upload spans reach the trace only where the
    # profiler's callbacks have reached that thread; the run's totals hold them
    assert set(res.spans) - names <= {"runner.upload"}
    s = tprof.device_summary(str(tmp_path))
    assert s["kernels"] == 0 and s["by_span"] == {}


def test_trace_writes_a_readable_trace(tmp_path):
    with tprof.trace(str(tmp_path)) as prof:
        with tprof.annotate("region"):
            torch.ones(64).cumsum(0)
    assert prof is not None
    names = [e.get("name") for e in json.loads((tmp_path / tprof.TRACE_FILE).read_text())
             ["traceEvents"]]
    assert "region" in names
    s = tprof.device_summary(str(tmp_path))
    assert s["kernels"] == 0 and s["device_busy_share"] == 0.0 and s["window_us"] > 0


def test_device_summary_counts_device_activity(tmp_path):
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "step", "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1.0, "dur": 2.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 5.0, "dur": 2.0},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 10.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 20.0, "dur": 20.0},   # overlaps a
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 60.0, "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 80.0, "dur": 10.0},
    ]
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": events}))
    s = tprof.device_summary(str(tmp_path / "t.json"), top=2)
    assert s["window_us"] == 100.0
    assert s["device_busy_us"] == 30.0 + 5.0 + 10.0
    assert s["kernels"] == 3 and s["launch_calls"] == 2 and s["graph_launches"] == 1
    assert [x["name"] for x in s["top"]] == ["a", "b"]
    assert s["top"][0]["total_us"] == 30.0 and s["top"][0]["calls"] == 2
