"""The port's incremental window solve against the JAX one, and a
radius-mode mission that runs it.

``optimize_window`` (``icpslam_tpu_torch/graph/pose_graph.py``) against
``icpslam_tpu.graph.pose_graph.optimize_window`` on one pose graph made
with numpy: 12 live nodes in a 16-node store, a noisy sequential chain,
two loop edges and an invalid edge past the count. GN and LM, with a
window that starts at node 0 (the gauge anchor is on) and one that
starts at node 7 (the frozen prefix anchors it, and the edges into the
prefix act as unary priors). Poses agree within 1e-4 (m and quaternion
components): both solve the same float32 system by Cholesky.

The mission: 20 scans of a room loop (1.25 laps) under a small config in
radius-covariance mode (r = 0.75 m, σ = 0.375 m, 2.5 voxel leaves, both
ICP stages) with ``graph_window`` 4 and a solve every 2 keyframes, so
window solves run from the 6th keyframe until the first loop closure
sends the solve back to the full graph. As in ``tests/test_torch_slam.py``:
(a) per step from one shared state (``utils/interop.py``): flags
identical, map size within 0.5%, pose within 1e-3 m and 1e-3 rad on the
scans where both odometry ICPs ran the same number of iterations (≥ 90%)
and within 5e-3 on all;
(b) free run: pose within 5 mm of the JAX one on every scan, flags
identical. The solve kind of every optimization (window or full) is the
same as JAX's rule gives, and the mission has both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icpslam_tpu.cloud import pointcloud as jpc
from icpslam_tpu.config import IcpConfig, tiny_config
from icpslam_tpu.geometry import se3 as jse3
from icpslam_tpu.graph import pose_graph as jpg
from icpslam_tpu.pipeline import slam as jslam
from icpslam_tpu_torch import config as tconfig
from icpslam_tpu_torch.cloud import pointcloud as tpc
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.graph import pose_graph as tpg
from icpslam_tpu_torch.io import synthetic as tsyn
from icpslam_tpu_torch.pipeline import slam as tslam
from icpslam_tpu_torch.utils import interop

K, E, COUNT = 16, 24, 12


def _quat(rng, n, scale):
    axis = rng.randn(n, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = rng.randn(n) * scale
    q = np.c_[np.cos(ang / 2), axis * np.sin(ang / 2)[:, None]]
    return q.astype(np.float32)


def _graph():
    """(nodes t, q), edges as numpy arrays, and the node mask."""
    rng = np.random.RandomState(0)
    t = np.cumsum(rng.randn(K, 3) * 0.5, axis=0).astype(np.float32)
    q = _quat(rng, K, 0.3)
    pairs = [(a, a + 1) for a in range(COUNT - 1)] + [(0, 9), (3, 10)]
    n_e = len(pairs)
    ei = np.zeros(E, np.int32)
    ej = np.zeros(E, np.int32)
    ei[:n_e], ej[:n_e] = np.array(pairs).T
    valid = np.zeros(E, bool)
    valid[:n_e] = True
    # relative measurements: the true relative pose from the (perturbed)
    # graph of the true poses, with noise
    truth = jse3.Pose(t=jnp.asarray(t), q=jnp.asarray(q))
    rel = jse3.relative(
        jse3.Pose(t=truth.t[ei], q=truth.q[ei]), jse3.Pose(t=truth.t[ej], q=truth.q[ej])
    )
    noise = jse3.se3_exp(jnp.asarray(rng.randn(E, 6).astype(np.float32) * 0.02))
    rel = jse3.compose(rel, noise)
    info = np.tile(np.diag([100.0] * 3 + [400.0] * 3).astype(np.float32), (E, 1, 1))
    info[9] *= 0.5
    # initial guess: the true poses with drift
    init = jse3.compose(
        truth, jse3.se3_exp(jnp.asarray(rng.randn(K, 6).astype(np.float32) * 0.05))
    )
    mask = np.arange(K) < COUNT
    edges = dict(i=ei, j=ej, rel_t=np.asarray(rel.t), rel_q=np.asarray(rel.q), info=info,
                 valid=valid, count=np.int32(n_e), overflow=np.int32(0))
    return np.asarray(init.t), np.asarray(init.q), edges, mask


@pytest.fixture(scope="module")
def graph():
    return _graph()


@pytest.mark.parametrize("mode", ["gn", "lm"])
@pytest.mark.parametrize("window", [16, 5])
def test_optimize_window_matches_jax(graph, mode, window):
    t, q, edges, mask = graph
    j_nodes, j_stats = jpg.optimize_window(
        jse3.Pose(t=jnp.asarray(t), q=jnp.asarray(q)),
        jpg.EdgeSet(**{k: jnp.asarray(v) for k, v in edges.items()}),
        jnp.asarray(mask), node_count=jnp.asarray(COUNT, jnp.int32), window=window,
        iterations=4, mode=mode,
    )
    calls = tpg.optimize_window.calls
    t_nodes, t_stats = tpg.optimize_window(
        Pose(t=torch.tensor(t), q=torch.tensor(q)),
        tpg.EdgeSet(**{k: torch.tensor(np.asarray(v)) for k, v in edges.items()}),
        torch.tensor(mask), COUNT, window, iterations=4, mode=mode,
    )
    assert tpg.optimize_window.calls == calls + 1
    np.testing.assert_allclose(t_nodes.t.numpy(), np.asarray(j_nodes.t), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_nodes.q.numpy(), np.asarray(j_nodes.q), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(t_stats.final_cost), float(j_stats.final_cost), rtol=1e-3)
    # the solve moved the window (but an anchored node 0) and left the
    # frozen prefix and the dead nodes where they were
    start = max(COUNT - window, 0)
    moved = np.abs(t_nodes.t.numpy() - t).max(1) > 1e-6
    assert moved[max(start, 1):COUNT].all()
    assert not moved[:start].any() and not moved[COUNT:].any()
    assert float(t_stats.final_cost) < float(t_stats.initial_cost)


def test_window_normal_equations_match_jax(graph):
    """The assembled window system, entry by entry, within 1e-5 of the
    largest entry of the system without the gauge anchor."""
    t, q, edges, mask = graph
    start, W = 7, 5
    local = (np.arange(W) + start < COUNT) & mask[start : start + W]
    tol_H = tol_b = None
    for anchor in (0.0, 1e6):
        jH, jb = jpg._window_normal_equations(
            jse3.Pose(t=jnp.asarray(t), q=jnp.asarray(q)),
            jpg.EdgeSet(**{k: jnp.asarray(v) for k, v in edges.items()}),
            jnp.asarray(start, jnp.int32), W, jnp.asarray(local), jnp.asarray(anchor, jnp.float32),
        )
        tH, tb = tpg._window_normal_equations(
            Pose(t=torch.tensor(t), q=torch.tensor(q)),
            tpg.EdgeSet(**{k: torch.tensor(np.asarray(v)) for k, v in edges.items()}),
            start, W, torch.from_numpy(local), anchor,
        )
        jH, jb = np.asarray(jH), np.asarray(jb)
        if tol_H is None:
            tol_H, tol_b = 1e-5 * np.abs(jH).max(), 1e-5 * np.abs(jb).max()
        np.testing.assert_allclose(tH.numpy(), jH, rtol=0, atol=tol_H)
        np.testing.assert_allclose(tb.numpy(), jb, rtol=0, atol=tol_b)


RADIUS = dict(covariance_mode="radius", covariance_radius=0.75, covariance_sigma=0.375)
MISSION = dict(
    voxel_leaf_size=0.3,
    map_resolution=0.3,
    max_points=512,
    max_raw_points=1024,
    max_map_points=8192,
    max_keyframes=32,
    max_edges=128,
    keyframe_distance=0.3,
    keyframes_window=2,
    graph_window=4,
    loop_closure_radius=3.0,
    loop_closure_min_id_gap=3,
)
CFG = tiny_config(
    icp_odometry=IcpConfig(mode="plane", max_iterations=10, **RADIUS),
    icp_mapping=IcpConfig(mode="plane", max_iterations=20, **RADIUS),
    **MISSION,
)
TCFG = tconfig.tiny_config(
    icp_odometry=tconfig.IcpConfig(mode="plane", max_iterations=10, **RADIUS),
    icp_mapping=tconfig.IcpConfig(mode="plane", max_iterations=20, **RADIUS),
    **MISSION,
)
N_SCANS = 20
FLAGS = {"accepted": 7, "refined": 11, "new_keyframe": 12, "loop_closure": 13,
         "optimized": 14, "num_keyframes": 16}


def _angle(qa, qb):
    d = np.abs(np.sum(qa.astype(np.float64) * qb.astype(np.float64), -1))
    return 2.0 * np.arccos(np.clip(d, 0.0, 1.0))


def _jax_solve_kinds(rec):
    """JAX's rule per optimized scan: 'window' when the graph outgrew the
    window and no loop closure arrived since the last solve, else 'full'."""
    kinds, lc_since = {}, 0
    for k, row in enumerate(rec):
        lc_since += int(row[FLAGS["loop_closure"]])
        if row[FLAGS["optimized"]]:
            full = lc_since > 0 or row[FLAGS["num_keyframes"]] <= CFG.graph_window
            kinds[k] = "full" if full else "window"
            lc_since = 0
    return kinds


@pytest.fixture(scope="module")
def mission():
    assert tconfig.from_dict(dataclasses.asdict(CFG)) == TCFG
    world = tsyn.make_room_world(0, 12000)
    gt_t, gt_q = tsyn.make_loop_trajectory(n_poses=N_SCANS, radius=3.0, laps=1.25)
    scans = list(tsyn.scan_stream(world, (gt_t, gt_q), capacity=CFG.max_raw_points,
                                  max_range=12.0, n_points=1000, noise=0.01, seed=1))
    step = jax.jit(jslam.slam_step, static_argnums=(2,))
    j_state = jslam.init_state(CFG, initial_pose=jse3.Pose(t=gt_t[0], q=gt_q[0]))
    free = tslam.init_state(TCFG, initial_pose=Pose(torch.tensor(gt_t[0]), torch.tensor(gt_q[0])),
                           device="cpu")
    rec = {"jax": [], "step": [], "free": []}
    port_kinds = {}
    for k, (pts, mask) in enumerate(scans):
        shared = interop.state_from_numpy(jax.tree_util.tree_map(np.asarray, j_state), device="cpu")
        port_scan = tpc.PointCloud(torch.tensor(pts), torch.tensor(mask))
        j_state, jo = step(j_state, jpc.PointCloud(points=pts, mask=mask), CFG)
        _, so = tslam.slam_step(shared, port_scan, TCFG)
        calls = tpg.optimize_window.calls
        free, fo = tslam.slam_step(free, port_scan, TCFG)
        if bool(fo.optimized):
            port_kinds[k] = "window" if tpg.optimize_window.calls > calls else "full"
        rec["jax"].append(np.asarray(jo.packed))
        rec["step"].append(so.packed.numpy())
        rec["free"].append(fo.packed.numpy())
    return {key: np.stack(v) for key, v in rec.items()}, port_kinds


def test_mission_runs_both_solve_kinds(mission):
    rec, port_kinds = mission
    kinds = _jax_solve_kinds(rec["jax"])
    assert port_kinds == kinds
    values = list(kinds.values())
    assert values.count("window") >= 2 and values.count("full") >= 2
    first_loop = int(np.argmax(rec["jax"][:, FLAGS["loop_closure"]] > 0))
    assert rec["jax"][first_loop, FLAGS["loop_closure"]] > 0
    assert any(k < first_loop and v == "window" for k, v in kinds.items())
    assert any(k >= first_loop and v == "full" for k, v in kinds.items())


@pytest.mark.parametrize("run", ["step", "free"])
def test_mission_flags_identical(mission, run):
    rec, _ = mission
    for name, col in FLAGS.items():
        np.testing.assert_array_equal(rec[run][:, col], rec["jax"][:, col], err_msg=name)


def test_mission_per_step_pose_and_map(mission):
    rec, _ = mission
    dt = np.linalg.norm(rec["step"][:, :3] - rec["jax"][:, :3], axis=-1)
    da = _angle(rec["step"][:, 3:7], rec["jax"][:, 3:7])
    # where the odometry ICPs ran the same number of iterations; an epsilon
    # exit a few iterations apart leaves a different remainder of the
    # convergence (millimetres), and it happens where the two packages'
    # radius covariances differ by their rounding (test_torch_radius.py)
    same = rec["step"][:, 10] == rec["jax"][:, 10]
    assert same.mean() >= 0.9, same
    assert dt[same].max() <= 1e-3, dt
    assert da[same].max() <= 1e-3, da
    assert dt.max() <= 5e-3 and da.max() <= 5e-3, (dt, da)
    j, s = rec["jax"][:, 15], rec["step"][:, 15]
    assert np.all(np.abs(s - j) <= 0.005 * j), (s, j)


def test_mission_free_run_pose(mission):
    rec, _ = mission
    dt = np.linalg.norm(rec["free"][:, :3] - rec["jax"][:, :3], axis=-1)
    assert dt.max() <= 5e-3, dt
