"""The sensor-physics half of the port's numpy producers
(``icpslam_tpu_torch/io/synthetic.py``) against the JAX package's.

Same seed, same arrays: every ``RandomState`` is drawn in JAX's order and
both compute in the same numpy dtypes, so the outputs are compared for
equality (``assert_array_equal``), not within a tolerance. Renders are
reduced to 16-32 beams × 256-512 azimuth bins. The idealized render is
held by ``tests/test_torch_package.py::TestProducers``.
"""

import torch

# one intra-op thread per test worker: the suite runs several pytest
# workers on the host's cores beside XLA's own pool
torch.set_num_threads(1)

import numpy as np
import pytest

from icpslam_tpu.io import synthetic as jsyn
from icpslam_tpu_torch.io import synthetic as tsyn

RENDER = dict(n_beams=16, azimuth_bins=256)


@pytest.fixture(scope="module")
def world():
    return tsyn.make_urban_world(seed=0)


def test_quaternion_helpers():
    rng = np.random.RandomState(0)
    q0 = rng.randn(4)
    u = rng.uniform(0, 1, 33)
    for q1 in (rng.randn(4), q0 + 1e-3 * rng.randn(4), -q0):  # slerp, lerp, flipped
        np.testing.assert_array_equal(tsyn._quat_slerp_np(q0, q1, u), jsyn._quat_slerp_np(q0, q1, u))
    a, b = rng.randn(4), rng.randn(4)
    np.testing.assert_array_equal(tsyn._quat_mul_np(a, b), jsyn._quat_mul_np(a, b))


@pytest.mark.parametrize("seed", [0, 5])
def test_moving_objects(seed):
    got, ref = tsyn.make_moving_objects(seed=seed), jsyn.make_moving_objects(seed=seed)
    for t in (0.0, 0.1, 7.3, 120.0):
        a = got(t)
        np.testing.assert_array_equal(a, ref(t))
        assert a.dtype == np.float32 and a.shape == (6 * 900, 3)


def test_ins_relative_motion():
    t, q = tsyn.make_urban_drive(n_poses=130)
    t, q = t.astype(np.float64), q.astype(np.float64)
    for noise in ((0.0, 0.0), (0.01, 0.002)):
        r1, r2 = np.random.RandomState(7), np.random.RandomState(7)
        for i in (0, 50, 106, 110, 129):
            a = tsyn.ins_relative_motion(t, q, i, r1, *noise)
            b = jsyn.ins_relative_motion(t, q, i, r2, *noise)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("with_times", [False, True])
def test_deskew_scan(with_times):
    rng = np.random.RandomState(2)
    pts = rng.uniform(-60, 60, (700, 3)).astype(np.float32)
    times = rng.uniform(0, 1, 700).astype(np.float32) if with_times else None
    rel_t, rel_q = np.array([0.8, 0.1, 0.0]), np.array([0.998, 0.0, 0.0, 0.0698])
    np.testing.assert_array_equal(tsyn.deskew_scan(pts, rel_t, rel_q, times),
                                  jsyn.deskew_scan(pts, rel_t, rel_q, times))


PHYSICS = {
    "distortion": dict(next_pose_t=np.array([120.8, 9.1, 1.7]),
                       next_pose_q=np.array([0.9998, 0.0, 0.0, 0.0175])),
    "range noise": dict(noise_range_coeff=3e-4),
    "dropout": dict(dropout=0.08),
    "all, with times": dict(next_pose_t=np.array([120.8, 9.1, 1.7]),
                            next_pose_q=np.array([0.9998, 0.0, 0.0, 0.0175]),
                            noise_range_coeff=3e-4, dropout=0.08, return_times=True),
}


@pytest.mark.parametrize("name", sorted(PHYSICS))
def test_render_velodyne_scan_physics(world, name):
    kw = dict(RENDER, seed=3, max_points=3000, **PHYSICS[name])
    t, q = np.array([120.0, 9.0, 1.7]), np.array([1.0, 0.0, 0.0, 0.0])
    got = tsyn.render_velodyne_scan(world, t, q, **kw)
    ref = jsyn.render_velodyne_scan(world, t, q, **kw)
    for a, b in zip(got if kw.get("return_times") else (got,),
                    ref if kw.get("return_times") else (ref,)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


STREAMS = {
    "distortion": dict(distortion=True),
    "dynamic": dict(dynamic="objects"),
    "distortion + deskew": dict(distortion=True, deskew=True, ins_noise_t=0.02),
    "runner physics": dict(distortion=True, dynamic="objects", noise_range_coeff=3e-4,
                           dropout=0.08),
    "runner physics + deskew": dict(distortion=True, deskew=True, dynamic="objects",
                                    noise_range_coeff=3e-4, dropout=0.08),
}


def _streams(world, kw, n=4, seed=0):
    kw = dict(kw)
    objects = kw.pop("dynamic", None) == "objects"
    g = jsyn.make_urban_drive(n_poses=n)
    ref = list(jsyn.velodyne_stream(
        world, g, capacity=4096, seed=seed,
        dynamic=jsyn.make_moving_objects(seed=0) if objects else None, **RENDER, **kw))
    got = list(tsyn.velodyne_stream(
        world, tsyn.make_urban_drive(n_poses=n), capacity=4096, seed=seed,
        dynamic=tsyn.make_moving_objects(seed=0) if objects else None, **RENDER, **kw))
    return got, ref


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_velodyne_stream_physics(world, name):
    got, ref = _streams(world, STREAMS[name])
    assert len(got) == len(ref) == 4
    for ((pts, mask), ts), (jc, js) in zip(got, ref):
        np.testing.assert_array_equal(mask, np.asarray(jc.mask))
        np.testing.assert_array_equal(pts, np.asarray(jc.points))
        assert ts == js


def test_ins_deskew_after_render_equals_the_deskewed_stream(world):
    """Chip phases 13 and 14 render once: de-skewing the distorted scans
    afterwards gives ``velodyne_stream(deskew=True)`` exactly."""
    kw = dict(STREAMS["runner physics"], dynamic=tsyn.make_moving_objects(seed=0))
    traj = tsyn.make_urban_drive(n_poses=5)
    raw = list(tsyn.velodyne_stream(world, traj, capacity=4096, seed=2, **RENDER, **kw))
    want = list(tsyn.velodyne_stream(world, traj, capacity=4096, seed=2, deskew=True,
                                     **RENDER, **dict(kw, dynamic=tsyn.make_moving_objects(seed=0))))
    got = list(tsyn.ins_deskew_stream(raw, traj, seed=2))
    assert len(got) == len(want) == 5
    for ((p, m), s), ((pw, mw), sw) in zip(got, want):
        np.testing.assert_array_equal(m, mw)
        np.testing.assert_array_equal(p, pw)
        assert s == sw
    # the last scan has no next pose: neither distorted nor de-skewed
    np.testing.assert_array_equal(got[-1][0][0], raw[-1][0][0])
