"""The port's wheel-odometry ingestion and wheel edges against the JAX ones
(``icpslam_tpu/pipeline/robot_odometry.py``, ``pipeline/slam.py``).

- ``robot_odometry_step`` on a numpy pose stream made from a seed, with
  moves below and above the 0.1 m gate and a covariance on some messages:
  outputs and state equal within 1e-5 after every message (offset removal
  and gating included).
- ``bootstrap_pose`` and ``ingest_wheel_odometry`` on the initial state
  and on one whose odometer has taken a scan: the odometer's and SLAM poses
  are seeded until then and left alone after, as in JAX.
- A 10-scan room loop with ``enable_wheel_odom_edges=True``, each scan
  preceded by a wheel pose (the ground truth with seeded noise, in a
  frame offset from the map): every keyframe pair after the first gets its
  wheel edge, and the edge stores of both packages agree in i and j, and
  in the wheel edges' rel within 1e-4.
"""

import torch

# one intra-op thread per test worker: the suite runs several pytest
# workers on the host's cores beside XLA's own pool
torch.set_num_threads(1)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from icpslam_tpu.cloud import pointcloud as jpc
from icpslam_tpu.config import IcpConfig, tiny_config
from icpslam_tpu.geometry import se3 as jse3
from icpslam_tpu.pipeline import robot_odometry as jro
from icpslam_tpu.pipeline import slam as jslam
from icpslam_tpu_torch import config as tconfig
from icpslam_tpu_torch.cloud import pointcloud as tpc
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.io import synthetic as tsyn
from icpslam_tpu_torch.pipeline import robot_odometry as tro
from icpslam_tpu_torch.pipeline import slam as tslam
from icpslam_tpu_torch.utils import interop


def _quat(rng, n, scale):
    axis = rng.randn(n, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = rng.randn(n) * scale
    return np.c_[np.cos(ang / 2), axis * np.sin(ang / 2)[:, None]].astype(np.float32)


def _close(got, want, atol=1e-5):
    """Every leaf of a port NamedTuple against the JAX one."""
    g = jax.tree_util.tree_leaves(interop.state_to_numpy(got))
    w = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=0, atol=atol)


def test_robot_odometry_step_matches_jax():
    cfg, tcfg = tiny_config(), tconfig.tiny_config()
    rng = np.random.RandomState(0)
    n = 24
    # steps of 0.02-0.3 m: some below the 0.1 m gate, some above
    steps = rng.uniform(0.02, 0.3, n)[:, None] * np.array([[1.0, 0.3, 0.05]])
    t = (np.array([5.0, -2.0, 0.5]) + np.cumsum(steps, axis=0)).astype(np.float32)
    q = _quat(rng, n, 0.3)
    js, ts = jro.init_state(), tro.init_state(device="cpu")
    gated = []
    for k in range(n):
        cov = np.diag(rng.uniform(0.01, 0.1, 6)).astype(np.float32) if k % 3 == 0 else None
        js, jo = jro.robot_odometry_step(
            js, jse3.Pose(t=jnp.asarray(t[k]), q=jnp.asarray(q[k])), cfg,
            None if cov is None else jnp.asarray(cov))
        ts, to = tro.robot_odometry_step(
            ts, Pose(t=torch.tensor(t[k]), q=torch.tensor(q[k])), tcfg,
            None if cov is None else torch.tensor(cov))
        _close(to, jo)
        _close(ts, js)
        gated.append(bool(to.gated))
    assert gated[0] and 0 < sum(gated[1:]) < n - 1  # the gate both passed and held
    assert int(ts.num_received) == n and int(ts.num_poses) == sum(gated)


CFG = tiny_config(
    voxel_leaf_size=0.3, map_resolution=0.3,
    icp_odometry=IcpConfig(mode="plane", max_iterations=10),
    icp_mapping=IcpConfig(mode="point", max_iterations=20),
    max_points=512, max_raw_points=1024, max_map_points=8192, max_keyframes=32,
    max_edges=128, keyframe_distance=0.3, keyframes_window=4,
    enable_loop_closure=False, enable_wheel_odom_edges=True,
)
TCFG = tconfig.from_dict(dataclasses.asdict(CFG))
N_SCANS = 10
# the wheel frame: the ground truth seen from another origin
OFFSET = (np.array([3.0, -1.0, 0.2], np.float32), _quat(np.random.RandomState(7), 1, 0.5)[0])


def _wheel_stream(gt_t, gt_q, seed):
    rng = np.random.RandomState(seed)
    off = jse3.Pose(t=jnp.asarray(OFFSET[0]), q=jnp.asarray(OFFSET[1]))
    truth = jse3.Pose(t=jnp.asarray(gt_t), q=jnp.asarray(gt_q))
    noise = jse3.se3_exp(jnp.asarray(rng.randn(len(gt_t), 6).astype(np.float32) * 0.005))
    w = jse3.compose(jse3.compose(jse3.Pose(t=jnp.broadcast_to(off.t, gt_t.shape),
                                            q=jnp.broadcast_to(off.q, gt_q.shape)), truth), noise)
    return np.asarray(w.t), np.asarray(w.q)


def test_bootstrap_and_ingest_match_jax():
    rng = np.random.RandomState(1)
    t0, q0 = np.array([1.0, 2.0, 0.0], np.float32), _quat(rng, 1, 0.3)[0]
    j = jslam.bootstrap_pose(jslam.init_state(CFG), jse3.Pose(t=jnp.asarray(t0), q=jnp.asarray(q0)))
    t = tslam.bootstrap_pose(tslam.init_state(TCFG, device="cpu"),
                             Pose(t=torch.tensor(t0), q=torch.tensor(q0)))
    _close(t.odom.pose, j.odom.pose)
    _close(t.slam_pose, j.slam_pose)
    gt_t, gt_q = tsyn.make_loop_trajectory(n_poses=4, radius=3.0, laps=0.3)
    wt, wq = _wheel_stream(gt_t, gt_q, seed=2)
    for k in range(4):
        if k == 2:  # a scan arrived: the wheel stream stops seeding the odometer
            j = j._replace(odom=j.odom._replace(initialized=jnp.asarray(True)))
            t = t._replace(odom=t.odom._replace(initialized=torch.tensor(True)))
        before = t.odom.pose
        j = jslam.ingest_wheel_odometry(j, jse3.Pose(t=jnp.asarray(wt[k]), q=jnp.asarray(wq[k])), CFG)
        t = tslam.ingest_wheel_odometry(t, Pose(t=torch.tensor(wt[k]), q=torch.tensor(wq[k])), TCFG)
        _close(t.robot_odom, j.robot_odom)
        _close(t.odom.pose, j.odom.pose)
        _close(t.slam_pose, j.slam_pose)
        if k < 2:  # seeded with the offset-removed wheel pose
            assert torch.equal(t.odom.pose.t, t.robot_odom.pose.t)
        else:
            assert torch.equal(t.odom.pose.t, before.t)


@pytest.fixture(scope="module")
def wheel_mission():
    world = tsyn.make_room_world(0, 12000)
    gt_t, gt_q = tsyn.make_loop_trajectory(n_poses=N_SCANS, radius=3.0, laps=0.6)
    wt, wq = _wheel_stream(gt_t, gt_q, seed=3)
    scans = list(tsyn.scan_stream(world, (gt_t, gt_q), capacity=CFG.max_raw_points,
                                  max_range=12.0, n_points=1000, noise=0.01, seed=1))
    step = jax.jit(jslam.slam_step, static_argnums=(2,))
    ingest = jax.jit(jslam.ingest_wheel_odometry, static_argnums=(2,))
    j = jslam.init_state(CFG, initial_pose=jse3.Pose(t=gt_t[0], q=gt_q[0]))
    t = tslam.init_state(TCFG, initial_pose=Pose(torch.tensor(gt_t[0]), torch.tensor(gt_q[0])),
                         device="cpu")
    new_kf = []
    for k, (pts, mask) in enumerate(scans):
        j = ingest(j, jse3.Pose(t=jnp.asarray(wt[k]), q=jnp.asarray(wq[k])), CFG)
        t = tslam.ingest_wheel_odometry(t, Pose(t=torch.tensor(wt[k]), q=torch.tensor(wq[k])), TCFG)
        j, jo = step(j, jpc.PointCloud(points=pts, mask=mask), CFG)
        t, to = tslam.slam_step(t, tpc.PointCloud(torch.tensor(pts), torch.tensor(mask)), TCFG)
        new_kf.append((bool(jo.new_keyframe), bool(to.new_keyframe)))
    return jax.tree_util.tree_map(np.asarray, j.edges), interop.state_to_numpy(t.edges), new_kf, j


def test_wheel_edges_match_jax(wheel_mission):
    j_edges, t_edges, new_kf, j_state = wheel_mission
    assert all(a == b for a, b in new_kf)
    n_kf = int(j_state.keyframes.count)
    assert n_kf >= 5
    # one sequential and one wheel edge per keyframe pair (the first
    # keyframe's wheel pose starts the chain)
    assert int(j_edges.count) == int(t_edges.count) == 2 * (n_kf - 1)
    c = int(j_edges.count)
    np.testing.assert_array_equal(t_edges.i[:c], j_edges.i[:c])
    np.testing.assert_array_equal(t_edges.j[:c], j_edges.j[:c])
    wheel = np.all(j_edges.info[:c] == np.diag(CFG.odometry_information).astype(np.float32), axis=(1, 2))
    assert wheel.sum() == n_kf - 1
    assert np.array_equal(j_edges.i[:c][wheel], np.arange(n_kf - 1))
    np.testing.assert_array_equal(t_edges.info[:c][wheel], j_edges.info[:c][wheel])
    np.testing.assert_allclose(t_edges.rel_t[:c][wheel], j_edges.rel_t[:c][wheel], rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_edges.rel_q[:c][wheel], j_edges.rel_q[:c][wheel], rtol=0, atol=1e-4)
