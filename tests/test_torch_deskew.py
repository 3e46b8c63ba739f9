"""In-loop de-skew of the port (``cloud/deskew.py``, ``ops/skew_icp.py``, the
de-skew branches of ``pipeline/odometry.py``) against the JAX package on
the CPU.

Inputs are sensor-physics sweeps of the urban proxy at a reduced render
(32 beams × 512 azimuth bins, 60 m range), voxel-filtered at 0.6 m into
2,048 points, made once by the port's numpy producers (equal to JAX's,
``tests/test_torch_physics.py``) and handed to both packages. JAX runs as
on the CPU: its 1-NN takes the XLA matmul-form path there.

Tolerances:
- the warp: 1e-5 m, about one float32 ulp of the up to 140 m terms the
  Rodrigues sum cancels (the trigonometry of either library rounds
  differently); the fractions 1e-6;
  the rows on the azimuth seam (``y = ±0, x < 0``) are compared on their
  own and must fall on the same side;
- the solvers, from the same filtered clouds: iterations and
  correspondence counts equal, pose and twist within 1e-4 (m, rad), the
  pose information within 1e-4 of its largest entry — the float32 sums
  run in another order;
- ``odometry_step`` from a shared state (the JAX state carried into the
  port before each scan, ``utils/interop.py``): accept flags, iterations,
  correspondence counts and masks equal; transform within 1e-4 m; the
  filtered and stashed clouds within 3e-4 m and the capture fractions
  within 1e-5 — the port's voxel filter sums its centroids in float64,
  JAX's in float32 (~1e-4 m apart); the covariances handed to mapping
  within 1e-3 on at least 99% of the points.
"""

import torch

# one intra-op thread per test worker: the suite runs several pytest
# workers on the host's cores beside XLA's own pool
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from icpslam_tpu.cloud import deskew as jdsk
from icpslam_tpu.cloud import pointcloud as jpc
from icpslam_tpu.cloud.voxel import voxel_downsample as jvox
from icpslam_tpu.config import IcpConfig as JIcp
from icpslam_tpu.config import kitti_config as jkitti
from icpslam_tpu.geometry.se3 import Pose as JPose
from icpslam_tpu.ops import covariance as jcov
from icpslam_tpu.ops import skew_icp as jskew
from icpslam_tpu.ops.pallas.nn_kernel import nearest_neighbors_pallas3
from icpslam_tpu.pipeline import odometry as jodo
from icpslam_tpu_torch.cloud import deskew as tdsk
from icpslam_tpu_torch.cloud import pointcloud as tpc
from icpslam_tpu_torch.cloud.voxel import voxel_downsample as tvox
from icpslam_tpu_torch.config import IcpConfig as TIcp
from icpslam_tpu_torch.config import kitti_config as tkitti
from icpslam_tpu_torch.geometry import quaternion as tquat
from icpslam_tpu_torch.geometry.se3 import Pose as TPose
from icpslam_tpu_torch.io import synthetic as tsyn
from icpslam_tpu_torch.ops import covariance as tcov
from icpslam_tpu_torch.ops import nn as tnn
from icpslam_tpu_torch.ops import skew_icp as tskew
from icpslam_tpu_torch.pipeline import odometry as todo
from icpslam_tpu_torch.utils import interop

RENDER = dict(n_beams=32, azimuth_bins=512)
ICP = dict(mode="plane", max_iterations=15, max_correspondence_distance=2.0, huber_delta=1.0)


def _yaw_q(deg: float) -> np.ndarray:
    h = np.radians(deg) / 2
    return np.array([np.cos(h), 0.0, 0.0, np.sin(h)])


class TestWarp:
    @staticmethod
    def _points():
        rng = np.random.RandomState(0)
        pts = rng.uniform(-80, 80, (512, 3)).astype(np.float32)
        # the azimuth seam: y = ±0 behind the sensor, and y = ±0 ahead
        pts[:8, 1] = 0.0
        pts[8:16, 1] = -0.0
        pts[:16, 0] = -np.abs(pts[:16, 0])
        pts[16:20, 1] = 0.0
        pts[16:20, 0] = np.abs(pts[16:20, 0])
        return pts

    def test_sweep_fraction(self):
        pts = self._points()
        ref = np.asarray(jdsk.sweep_fraction(jnp.asarray(pts)))
        got = tdsk.sweep_fraction(torch.from_numpy(pts)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        # the seam rows: +0 gives u = 1, -0 gives u = 0 in both
        np.testing.assert_array_equal(got[:8] > 0.5, ref[:8] > 0.5)
        np.testing.assert_array_equal(got[8:16] > 0.5, ref[8:16] > 0.5)
        assert (got[:8] == 1.0).all() and (got[8:16] == 0.0).all()

    @pytest.mark.parametrize("yaw", [0.0, 8.0, -175.0])
    def test_deskew_points(self, yaw):
        pts = self._points()
        rng = np.random.RandomState(1)
        rel_t = np.array([0.8, 0.1, 0.02], np.float32)
        rel_q = _yaw_q(yaw).astype(np.float32)
        u = rng.uniform(0, 1, pts.shape[0]).astype(np.float32)
        u[:16] = np.asarray(jdsk.sweep_fraction(jnp.asarray(pts)))[:16]
        ref = np.asarray(jdsk.deskew_points(
            jnp.asarray(pts), jnp.asarray(u), JPose(t=jnp.asarray(rel_t), q=jnp.asarray(rel_q))))
        got = tdsk.deskew_points(
            torch.from_numpy(pts), torch.from_numpy(u),
            TPose(t=torch.from_numpy(rel_t), q=torch.from_numpy(rel_q))).numpy()
        np.testing.assert_allclose(got[16:], ref[16:], rtol=0, atol=1e-5)
        # the seam: u = 1 takes the whole sweep's motion, u = 0 none
        np.testing.assert_allclose(got[:16], ref[:16], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[8:16], pts[8:16], rtol=0, atol=1e-6)


def _render_pair(rel_t, yaw, seed=0):
    """Two consecutive smeared sweeps (the second continues the motion)."""
    world = tsyn.make_urban_world(seed=0)
    rel_q = _yaw_q(yaw)
    R = np.array([[np.cos(np.radians(yaw)), -np.sin(np.radians(yaw)), 0],
                  [np.sin(np.radians(yaw)), np.cos(np.radians(yaw)), 0], [0, 0, 1.0]])
    t0, q0 = np.array([40.0, 9.0, 1.7]), np.array([1.0, 0.0, 0.0, 0.0])
    t1, q1 = t0 + rel_t, tsyn._quat_mul_np(q0, rel_q)
    t2, q2 = t1 + R @ rel_t, tsyn._quat_mul_np(q1, rel_q)
    kw = dict(max_range=60.0, **RENDER)
    s0 = tsyn.render_velodyne_scan(world, t0, q0, seed=seed + 1, next_pose_t=t1, next_pose_q=q1, **kw)
    s1 = tsyn.render_velodyne_scan(world, t1, q1, seed=seed + 2, next_pose_t=t2, next_pose_q=q2, **kw)
    return s0, s1


@pytest.fixture(scope="module", params=["straight", "turning"])
def pair(request):
    rel_t, yaw = ((np.array([0.8, 0.0, 0.0]), 0.0) if request.param == "straight"
                  else (np.array([0.8, 0.1, 0.0]), 8.0))
    out = {"jax": [], "port": []}
    for s in _render_pair(rel_t, yaw):
        p, m = tsyn.pad(s, 16384)
        jf, _ = jvox(jpc.PointCloud(jnp.asarray(p), jnp.asarray(m)), 0.6, 2048)
        tf, _ = tvox(tpc.PointCloud(torch.from_numpy(p), torch.from_numpy(m)), 0.6, 2048)
        out["jax"].append((jf, jcov.gicp_covariances(jf, k=10)))
        out["port"].append((tf, tcov.gicp_covariances(tf, k=10)))
    return out


def _close(jr, tr):
    assert int(jr.iterations) == int(tr.iterations)
    assert int(jr.num_correspondences) == int(tr.num_correspondences)
    assert bool(jr.converged) and bool(tr.converged)
    np.testing.assert_allclose(tr.pose.t.numpy(), np.asarray(jr.pose.t), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tr.pose.q.numpy(), np.asarray(jr.pose.q), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tr.skew_twist.numpy(), np.asarray(jr.skew_twist), rtol=0, atol=1e-4)
    H = np.asarray(jr.hessian)
    np.testing.assert_allclose(tr.hessian.numpy(), H, rtol=0, atol=1e-4 * np.abs(H).max())


COUPLED = {
    "cv-tied": dict(free_source_twist=False),
    "free-twist": dict(free_source_twist=True, source_twist_prior_weight=100.0),
    "free-twist huber": dict(free_source_twist=True, source_twist_prior_weight=100.0,
                             prior_huber_delta=0.005),
    "free-twist auto-prior": dict(free_source_twist=True, source_twist_prior_weight=100.0,
                                  auto_prior=(2000.0, 100.0, 0.02)),
}


@pytest.mark.parametrize("variant", sorted(COUPLED))
def test_coupled_deskew_icp_matches_jax(pair, variant):
    kw = dict(COUPLED[variant], want_hessian=True)
    (j0, jc0), (j1, jc1) = pair["jax"]
    (t0, tc0), (t1, tc1) = pair["port"]
    jr = jskew.coupled_deskew_icp(
        j1, j0, jdsk.sweep_fraction(j0.points), JIcp(**ICP),
        source_u=jdsk.sweep_fraction(j1.points), source_covs=jc1, target_covs=jc0,
        target_valid_len=jnp.sum(j0.mask.astype(jnp.int32)), **kw)
    tr = tskew.coupled_deskew_icp(
        t1, t0, tdsk.sweep_fraction(t0.points), TIcp(**ICP),
        source_u=tdsk.sweep_fraction(t1.points), source_covs=tc1, target_covs=tc0,
        target_valid_len=t0.mask.sum(dtype=torch.int32), **kw)
    _close(jr, tr)


def test_skew_aware_icp_matches_jax(pair):
    (j0, jc0), (j1, jc1) = pair["jax"]
    (t0, tc0), (t1, tc1) = pair["port"]
    seed = np.array([0.7, 0.0, 0.0, 0.0, 0.0, 0.01], np.float32)
    jr = jskew.skew_aware_icp(
        j1, j0, JIcp(**ICP), jdsk.sweep_fraction(j1.points), init_skew=jnp.asarray(seed),
        source_covs=jc1, target_covs=jc0, want_hessian=True)
    tr = tskew.skew_aware_icp(
        t1, t0, TIcp(**ICP), tdsk.sweep_fraction(t1.points), init_skew=torch.from_numpy(seed),
        source_covs=tc1, target_covs=tc0, want_hessian=True)
    _close(jr, tr)


def test_uncapped_nn_gives_the_capped_correspondences(pair):
    """JAX caps K1 at the gate (``prune_beyond=max_d2``, skew_icp.py:198);
    the port's K1 is exact everywhere. The cap changes only matches beyond
    the gate, which ``corr`` drops again, so the correspondence set of a
    coupled step is the same: checked at the start pose and at the solved
    pose, JAX's kernel run in interpret mode with the cap."""
    (t0, tc0), (t1, tc1) = pair["port"]
    icfg = TIcp(**ICP)
    max_d2 = icfg.max_correspondence_distance ** 2
    u0, u1 = tdsk.sweep_fraction(t0.points), tdsk.sweep_fraction(t1.points)
    solved = tskew.coupled_deskew_icp(t1, t0, u0, icfg, source_u=u1, source_covs=tc1,
                                      target_covs=tc0).pose
    vl = t0.mask.sum(dtype=torch.int32)
    n_gated = 0
    for pose in (TPose(t=torch.zeros(3), q=torch.tensor([1.0, 0.0, 0.0, 0.0])), solved):
        R = tquat.to_matrix(pose.q)
        P = (tdsk.deskew_points(t1.points, u1, pose) @ R.T + pose.t).contiguous()
        qw = tdsk.deskew_points(t0.points, u0, pose).contiguous()
        mine = tnn.nearest_neighbors_plain(P, qw, t0.mask, vl)
        capped = nearest_neighbors_pallas3(
            jnp.asarray(P.numpy()), jnp.asarray(qw.numpy()), jnp.asarray(t0.mask.numpy()),
            valid_len=jnp.asarray(int(vl), jnp.int32), bq=256, bt=256, interpret=True,
            prune_beyond=float(max_d2))
        corr = []
        for idx, found in ((mine.idx.numpy(), np.isfinite(mine.dist2.numpy())),
                           (np.asarray(capped.idx), np.isfinite(np.asarray(capped.dist2)))):
            r = P.numpy() - qw.numpy()[idx]
            corr.append(t1.mask.numpy() & found & ((r * r).sum(-1) <= max_d2))
        np.testing.assert_array_equal(corr[0], corr[1])
        n_gated += int((t1.mask.numpy() & ~corr[0]).sum())
    assert n_gated > 0  # the start pose leaves some points beyond the gate


def _physics_scans(n=5):
    """``n`` physics scans through the first corner of the urban drive."""
    world = tsyn.make_urban_world(seed=0)
    t, q = tsyn.make_urban_drive(n_poses=112)
    traj = (t[104 : 104 + n], q[104 : 104 + n])
    return list(tsyn.velodyne_stream(
        world, traj, capacity=16384, dynamic=tsyn.make_moving_objects(seed=0), distortion=True,
        noise_range_coeff=3e-4, dropout=0.08, **RENDER))


REDUCED = dict(max_raw_points=16384, max_points=2048, voxel_leaf_size=0.6, map_resolution=0.6)
MODES = {
    "coupled free-twist": dict(deskew_rounds=1, deskew_mode="coupled", deskew_free_twist=True),
    "coupled cv-tied": dict(deskew_rounds=1, deskew_mode="coupled"),
    "joint": dict(deskew_rounds=1, deskew_mode="joint"),
    "alternate 2 rounds": dict(deskew_rounds=2, deskew_mode="alternate"),
}


@pytest.fixture(scope="module")
def physics_scans():
    return _physics_scans()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_odometry_step_matches_jax(physics_scans, mode):
    jc, tc = jkitti(**REDUCED, **MODES[mode]), tkitti(**REDUCED, **MODES[mode])
    step = jax.jit(jodo.odometry_step, static_argnums=(2,))
    js = jodo.init_state(jc)
    accepted = 0
    for (p, m), _ in physics_scans:
        tree = jax.tree_util.tree_map(np.asarray, js)
        ts = interop.state_from_numpy(tree, device="cpu", cls=todo.OdometryState)
        init = bool(tree.initialized)
        skip = init and int(tree.skip_count) > 0
        ts, tout = todo.odometry_step(
            ts, tpc.PointCloud(torch.from_numpy(p), torch.from_numpy(m)), tc, init and not skip, skip)
        js, jout = step(js, jpc.PointCloud(p, m), jc)
        assert bool(tout.accepted) == bool(jout.accepted)
        assert int(tout.iterations) == int(jout.iterations)
        assert int(tout.num_correspondences) == int(jout.num_correspondences)
        accepted += int(bool(jout.accepted))
        np.testing.assert_allclose(tout.transform.t.numpy(), np.asarray(jout.transform.t), atol=1e-4)
        np.testing.assert_allclose(tout.transform.q.numpy(), np.asarray(jout.transform.q), atol=1e-4)
        np.testing.assert_array_equal(tout.filtered.mask.numpy(), np.asarray(jout.filtered.mask))
        np.testing.assert_allclose(tout.filtered.points.numpy(), np.asarray(jout.filtered.points),
                                   atol=3e-4)
        np.testing.assert_array_equal(ts.prev_cloud.mask.numpy(), np.asarray(js.prev_cloud.mask))
        np.testing.assert_allclose(ts.prev_cloud.points.numpy(), np.asarray(js.prev_cloud.points),
                                   atol=3e-4)
        np.testing.assert_allclose(ts.prev_u.numpy(), np.asarray(js.prev_u), atol=1e-5)
        close = (np.abs(tout.filtered_covs.numpy() - np.asarray(jout.filtered_covs)) <= 1e-3).all(0)
        assert close.mean() >= 0.99, close.mean()
    assert accepted == len(physics_scans) - 1
    if mode.startswith("coupled"):
        # the stash is the skewed cloud: its fractions are its own azimuths
        u = tdsk.sweep_fraction(ts.prev_cloud.points)
        live = ts.prev_cloud.mask
        np.testing.assert_allclose(ts.prev_u[live].numpy(), u[live].numpy(), atol=1e-6)
