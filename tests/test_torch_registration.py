"""Port geometry, ICP, pose graph and metrics against the JAX package.

Inputs come from numpy seeds and go to both packages. Tolerances: 1e-5
for closed-form geometry (float32, same formulas, other evaluation order),
1e-4 m / rad for registrations and graph solves (iterative, float32).
"""

import torch

# one intra-op thread per test worker: the suite runs several pytest
# workers on the host's cores beside XLA's own pool
torch.set_num_threads(1)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from icpslam_tpu.cloud import pointcloud as jpc
from icpslam_tpu.config import IcpConfig
from icpslam_tpu.eval import metrics as jmetrics
from icpslam_tpu.geometry import se3 as jse3
from icpslam_tpu.graph import pose_graph as jpg
from icpslam_tpu.ops import covariance as jcov
from icpslam_tpu.ops import icp as jicp
from icpslam_tpu_torch.cloud import pointcloud as tpc
from icpslam_tpu_torch.eval import metrics as tmetrics
from icpslam_tpu_torch.geometry import se3 as tse3
from icpslam_tpu_torch.graph import pose_graph as tpg
from icpslam_tpu_torch.ops import covariance as tcov
from icpslam_tpu_torch.ops import icp as ticp
from icpslam_tpu_torch.io import synthetic as tsyn


def _t(a):
    return torch.tensor(np.asarray(a))


def _twists(seed=0, n=16):
    rng = np.random.RandomState(seed)
    xi = (rng.randn(n, 6) * [1, 1, 1, 0.8, 0.8, 0.8]).astype(np.float32)
    xi[0] = 0.0
    xi[1, 3:] = 1e-7
    return xi


def test_se3_exp_log_jacobians():
    xi = _twists()
    jp = jse3.se3_exp(jnp.asarray(xi))
    tp = tse3.se3_exp(_t(xi))
    np.testing.assert_allclose(tp.t.numpy(), np.asarray(jp.t), atol=1e-5)
    np.testing.assert_allclose(tp.q.numpy(), np.asarray(jp.q), atol=1e-5)
    np.testing.assert_allclose(
        tse3.se3_log(tp).numpy(), np.asarray(jse3.se3_log(jp)), atol=1e-5
    )
    np.testing.assert_allclose(
        tse3.se3_right_jacobian_inv(_t(xi)).numpy(),
        np.asarray(jse3.se3_right_jacobian_inv(jnp.asarray(xi))), atol=1e-5,
    )
    np.testing.assert_allclose(
        tse3.adjoint(tp).numpy(), np.asarray(jse3.adjoint(jp)), atol=1e-5
    )
    assert torch.isfinite(tse3.se3_log(tse3.se3_exp(torch.zeros(6)))).all()


def _room_cloud(seed, pose_idx, n_points=800):
    world = tsyn.make_room_world(seed, 8000)
    gt = tsyn.make_loop_trajectory(n_poses=12, radius=3.0)
    pts, mask = list(tsyn.scan_stream(world, gt, capacity=1024, max_range=12.0,
                                      n_points=n_points, noise=0.01))[pose_idx]
    from icpslam_tpu.cloud.voxel import voxel_downsample

    f, _ = voxel_downsample(jpc.PointCloud(jnp.asarray(pts), jnp.asarray(mask)), 0.3, 512)
    return np.asarray(f.points), np.asarray(f.mask)


@pytest.mark.parametrize("mode", ["plane", "point"])
def test_icp_matches_jax(mode):
    src, smask = _room_cloud(0, 1)
    tgt, tmask = _room_cloud(0, 0)
    cfg = IcpConfig(mode=mode, max_iterations=10, max_correspondence_distance=2.0)
    init = jse3.Pose(t=jnp.asarray([0.3, -0.2, 0.0]), q=jnp.asarray([0.99, 0.0, 0.0, 0.14]))
    init = jse3.normalize(init)
    js, jt = jpc.PointCloud(jnp.asarray(src), jnp.asarray(smask)), jpc.PointCloud(jnp.asarray(tgt), jnp.asarray(tmask))
    ts, tt = tpc.PointCloud(_t(src), _t(smask)), tpc.PointCloud(_t(tgt), _t(tmask))
    kw_j, kw_t = {}, {}
    if mode == "plane":
        kw_j = dict(source_covs=jcov.gicp_covariances(js), target_covs=jcov.gicp_covariances(jt))
        kw_t = dict(source_covs=tcov.gicp_covariances(ts), target_covs=tcov.gicp_covariances(tt))
    rj = jicp.icp(js, jt, cfg, init=init, want_hessian=True, **kw_j)
    rt = ticp.icp(ts, tt, cfg, init=tse3.Pose(_t(init.t), _t(init.q)), want_hessian=True, **kw_t)
    assert int(rt.iterations) == int(rj.iterations)
    assert bool(rt.converged) == bool(rj.converged)
    assert int(rt.num_correspondences) == int(rj.num_correspondences)
    np.testing.assert_allclose(rt.pose.t.numpy(), np.asarray(rj.pose.t), atol=1e-4)
    np.testing.assert_allclose(rt.pose.q.numpy(), np.asarray(rj.pose.q), atol=1e-4)
    np.testing.assert_allclose(float(rt.fitness), float(rj.fitness), rtol=1e-4)
    hj = np.asarray(rj.hessian)
    np.testing.assert_allclose(rt.hessian.numpy(), hj, rtol=1e-3, atol=1e-3 * np.abs(hj).max())


def test_icp_fixed_correspondences_matches_jax():
    src, smask = _room_cloud(1, 2)
    rng = np.random.RandomState(3)
    tgt = src + rng.randn(*src.shape).astype(np.float32) * 0.01 + np.float32([0.05, -0.03, 0.0])
    cfg = IcpConfig(mode="point", max_iterations=30)
    rj = jicp.icp(jpc.PointCloud(jnp.asarray(src), jnp.asarray(smask)),
                  jpc.PointCloud(jnp.asarray(tgt), jnp.asarray(smask)), cfg,
                  fixed_correspondences=True)
    rt = ticp.icp(tpc.PointCloud(_t(src), _t(smask)), tpc.PointCloud(_t(tgt), _t(smask)), cfg,
                  fixed_correspondences=True)
    assert int(rt.iterations) == int(rj.iterations)
    np.testing.assert_allclose(rt.pose.t.numpy(), np.asarray(rj.pose.t), atol=1e-5)
    np.testing.assert_allclose(rt.pose.q.numpy(), np.asarray(rj.pose.q), atol=1e-5)


def _graph(seed=0, K=10):
    rng = np.random.RandomState(seed)
    gt = _twists(seed + 1, K) * 0.5
    gt[0] = 0.0
    pairs = [(i, i + 1) for i in range(K - 1)] + [(0, K - 1), (2, 7)]
    meas = []
    for i, j in pairs:
        noise = (rng.randn(6) * 0.02).astype(np.float32)
        meas.append(noise)
    init = gt + (rng.randn(K, 6) * 0.05).astype(np.float32)
    init[0] = gt[0]
    return gt, init, pairs, np.stack(meas)


def test_pose_graph_optimize_matches_jax():
    gt, init, pairs, noise = _graph()
    K, E = gt.shape[0], len(pairs)
    cap_e = 16
    j_nodes = jse3.se3_exp(jnp.asarray(init))
    j_gt = jse3.se3_exp(jnp.asarray(gt))
    t_nodes = tse3.Pose(_t(j_nodes.t), _t(j_nodes.q))
    j_edges, t_edges = jpg.empty_edges(cap_e), tpg.empty_edges(cap_e)
    info = np.diag([100.0] * 6).astype(np.float32)
    for (i, j), n in zip(pairs, noise):
        rel = jse3.compose(jse3.relative(jse3.index(j_gt, i), jse3.index(j_gt, j)), jse3.se3_exp(jnp.asarray(n)))
        j_edges = jpg.add_edge(j_edges, i, j, rel, jnp.asarray(info))
        t_edges = tpg.add_edge(t_edges, i, j, tse3.Pose(_t(rel.t), _t(rel.q)), _t(info))
    mask = np.ones(K, bool)
    jo, js = jpg.optimize(j_nodes, j_edges, jnp.asarray(mask), iterations=3, mode="lm")
    to, ts = tpg.optimize(t_nodes, t_edges, _t(mask), iterations=3, mode="lm")
    np.testing.assert_allclose(to.t.numpy(), np.asarray(jo.t), atol=1e-4)
    np.testing.assert_allclose(to.q.numpy(), np.asarray(jo.q), atol=1e-4)
    np.testing.assert_allclose(float(ts.final_cost), float(js.final_cost), rtol=1e-3)
    # the live-size bucketed solve equals the JAX bucketed one on a
    # larger, partly empty store
    big_j = jse3.Pose(t=jnp.zeros((32, 3)).at[:K].set(j_nodes.t),
                      q=jnp.zeros((32, 4)).at[:, 0].set(1.0).at[:K].set(j_nodes.q))
    jb, _ = jpg.optimize_bucketed(big_j, j_edges, jnp.arange(32) < K, node_count=K,
                                  edge_count=E, min_bucket=16, iterations=3, mode="lm",
                                  linear_solver="auto")
    tb, _ = tpg.optimize_bucketed(tse3.Pose(_t(big_j.t), _t(big_j.q)), t_edges,
                                  torch.arange(32) < K, K, E, min_bucket=16,
                                  iterations=3, mode="lm", linear_solver="auto")
    np.testing.assert_allclose(tb.t.numpy(), np.asarray(jb.t), atol=1e-4)
    np.testing.assert_allclose(tb.q.numpy(), np.asarray(jb.q), atol=1e-4)


def test_metrics_match_jax():
    t, q = tsyn.make_loop_trajectory(n_poses=20, radius=4.0)
    rng = np.random.RandomState(5)
    est_t = (t + rng.randn(*t.shape) * 0.05).astype(np.float32)
    gt = jse3.Pose(t=jnp.asarray(t), q=jnp.asarray(q))
    est = jse3.Pose(t=jnp.asarray(est_t), q=jnp.asarray(q))
    tgt, test_ = tse3.Pose(_t(t), _t(q)), tse3.Pose(_t(est_t), _t(q))
    np.testing.assert_allclose(tmetrics.ate(test_, tgt)[0], jmetrics.ate(est, gt)[0], rtol=1e-4)
    np.testing.assert_allclose(tmetrics.rpe(test_, tgt), jmetrics.rpe(est, gt), rtol=1e-4, atol=1e-6)
