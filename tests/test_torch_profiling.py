"""The port's profiling and roofline modules (``icpslam_tpu_torch/utils/``)
against the JAX ones: ``StageTimer``'s summary has JAX's keys, and every
roofline stage model gives JAX's ``flops``, ``bytes`` and ``bound`` for the
same arguments (numbers made with numpy from a seed). ``achieved`` divides
by the H100's published FP32 and HBM3 peaks; a trace written by ``trace``
on the CPU is read back by ``device_summary``."""

import torch

# one intra-op thread per test worker: the suite runs several pytest
# workers on the host's cores beside XLA's own pool
torch.set_num_threads(1)

import json

import numpy as np
import pytest

from icpslam_tpu.utils import profiling as jprof
from icpslam_tpu.utils import roofline as jroof
from icpslam_tpu_torch.utils import profiling as tprof
from icpslam_tpu_torch.utils import roofline as troof

_RNG = np.random.RandomState(7)
_ARGS = {
    "nn_pairs_model": [(int(_RNG.randint(100, 9000)), int(_RNG.randint(100, 300000)),
                        float(_RNG.uniform(1, 10))) for _ in range(3)],
    "voxel_filter_model": [(int(_RNG.randint(2, 200000)),) for _ in range(3)],
    "covariance_model": [(int(_RNG.randint(100, 9000)), int(_RNG.randint(4, 20))) for _ in range(3)],
    "icp_model": [(int(_RNG.randint(100, 9000)), int(_RNG.randint(100, 9000)),
                   float(_RNG.uniform(1, 10)), plane, per_iter)
                  for plane in (True, False) for per_iter in (True, False)],
    "scan_to_map_model": [(int(_RNG.randint(100, 9000)), int(_RNG.randint(0, 300000)),
                           float(_RNG.uniform(1, 30)), plane, fixed)
                          for plane in (True, False) for fixed in (True, False)],
}


@pytest.mark.parametrize("name", sorted(_ARGS))
def test_stage_models_match_jax(name):
    for args in _ARGS[name]:
        got, want = getattr(troof, name)(*args), getattr(jroof, name)(*args)
        assert got["flops"] == want["flops"], args
        assert got["bytes"] == want["bytes"], args
        assert got["bound"] == want["bound"], args
        assert got["note"] == want["note"], args


def test_stage_rooflines_match_jax_models():
    kw = dict(raw_points=131072, n_points=8192, covariance_knn=10, odo_iterations=6.5,
              map_iterations=11.0, map_fill=22006)
    stage_ms = {"voxel_filter": 1.5, "covariances": 0.8, "icp_odometry": 9.0,
                "scan_to_map_refine": 6.0, "other": 3.0}
    got = troof.stage_rooflines(stage_ms, **kw)
    want = jroof.stage_rooflines(stage_ms, **kw)
    assert sorted(got) == sorted(want) == sorted(set(stage_ms) - {"other"})
    for name in got:
        assert set(got[name]) == set(want[name])
        for key in ("gflops", "gbps", "bound", "note", "ms"):
            assert got[name][key] == want[name][key], (name, key)
        assert got[name]["frac_hbm"] == round(got[name]["gbps"] / 3350.0, 4)
        assert got[name]["frac_compute"] == round(got[name]["gflops"] / 67e3, 4)


def test_stage_timer_summary_keys_match_jax():
    t_timer, j_timer = tprof.StageTimer(), jprof.StageTimer()
    for timer in (t_timer, j_timer):
        for name in ("odometry", "graph", "odometry"):
            with timer.stage(name):
                pass
        timer.time_stage("scan_to_map", lambda: 1)
    got, want = t_timer.summary(), j_timer.summary()
    assert list(got) == list(want) == ["graph", "odometry", "scan_to_map"]
    for k in got:
        assert set(got[k]) == set(want[k])
        assert got[k]["count"] == want[k]["count"]
    assert t_timer.report().splitlines()[0] == j_timer.report().splitlines()[0]
    assert len(t_timer.report().splitlines()) == 4


def test_stage_timer_blocks_on_cpu_tensors():
    timer = tprof.StageTimer()
    x = torch.ones(4)
    with timer.stage("add", block_on={"a": (x, [x + 1])}):
        x = x + 1
    assert timer.time_stage("mul", lambda: x * 2).sum() == 16
    assert timer.summary()["add"]["count"] == 1


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
