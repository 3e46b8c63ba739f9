"""The port's ``parallel/`` against the JAX package's on the CPU (the JAX
side jitted on the 8-virtual-device mesh of ``conftest.py``; the port on
a mesh of 8 shards in one process).

- ``sharded_nn``: indices equal, d² within 1e-5 (JAX's own test).
- ``sharded_edge_contributions``: H and b within 1e-4.
- ``dist_graph.optimize``: direct in GN and LM, PCG and Schur in LM, and
  Schur's separator overflow falling back to the direct solve: t within
  1e-3 m and the final cost within rtol 1e-2 of JAX's (the tolerances of
  ``tests/test_parallel.py``: the edge-sharded sums reduce in another
  order than one scatter-add).
- ``chain_poses`` within 1e-5, and one ``batched_slam_step`` of B = 7
  point-mode pairs: relative poses within 1e-3 m of JAX's vmapped ICP,
  the chained and solved trajectory too.
- The streaming step with the dist-* solvers (the port only; JAX's
  streaming dist drives already spend minutes of the suite): dist-direct
  and dist-schur within 1e-3 and 2e-3 m of the replicated direct solver,
  JAX's tolerances; dist-pcg with the sharded map; JAX's ``ValueError``s
  without a mesh.
- ``parallel/scaling.py``: its rung format and efficiency math, as
  ``tests/test_scaling_roofline.py`` checks JAX's.
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

from icpslam_tpu import cloud as jpc
from icpslam_tpu.config import IcpConfig as JIcpConfig
from icpslam_tpu.geometry import se3 as jse3
from icpslam_tpu.graph import pose_graph as jpg
from icpslam_tpu.io import synthetic as jsyn
from icpslam_tpu.parallel import dist_graph as jdg
from icpslam_tpu.parallel import dist_step as jds
from icpslam_tpu.parallel import mesh as jmesh_lib
from icpslam_tpu.parallel import sharded_nn as jsnn
from icpslam_tpu_torch.cloud.pointcloud import PointCloud
from icpslam_tpu_torch.config import IcpConfig, tiny_config
from icpslam_tpu_torch.geometry import se3 as tse3
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.graph import pose_graph as tpg
from icpslam_tpu_torch.io import synthetic as tsyn
from icpslam_tpu_torch.parallel import dist_graph as tdg
from icpslam_tpu_torch.parallel import dist_step as tds
from icpslam_tpu_torch.parallel import mesh as tmesh_lib
from icpslam_tpu_torch.parallel import scaling as tscaling
from icpslam_tpu_torch.parallel import sharded_nn as tsnn
from icpslam_tpu_torch.pipeline import deferred as tdeferred
from icpslam_tpu_torch.pipeline import slam as tslam

from test_graph import build_chain_edges, circle_poses


@pytest.fixture(scope="module")
def jmesh8():
    return jmesh_lib.make_mesh(8)


@pytest.fixture(scope="module")
def tmesh8():
    return tmesh_lib.make_mesh(8, device="cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _pose(p):
    return Pose(t=_t(p.t), q=_t(p.q))


def _edges(e):
    return tpg.EdgeSet(**{f: _t(getattr(e, f)) for f in tpg.EdgeSet._fields})


def test_sharded_nn_matches_jax(jmesh8, tmesh8):
    rng = np.random.RandomState(0)
    q = rng.randn(128, 3).astype(np.float32)
    t = rng.randn(96, 3).astype(np.float32)
    tm = np.ones(96, bool)
    tm[::7] = False
    want = jax.jit(lambda a, b, c: jsnn.nearest_neighbors(a, b, c, jmesh8, block=16))(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(tm))
    got = tsnn.nearest_neighbors(_t(q), _t(t), _t(tm), tmesh8)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_allclose(got.dist2.numpy(), np.asarray(want.dist2), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        tsnn.nearest_neighbors(torch.zeros((10, 3)), _t(t), _t(tm), tmesh8)


@pytest.mark.parametrize("info_scale", [1.0, 100.0])
def test_sharded_edge_contributions_match_jax(info_scale, jmesh8, tmesh8):
    gt = circle_poses(10)
    edges = build_chain_edges(gt, capacity=13, info_scale=info_scale, noise=0.05, seed=0,
                              close_loop=True)
    noisy = jse3.compose(gt, jse3.se3_exp(jnp.full((10, 6), 0.03)))
    H, b = jax.jit(lambda n, e: jdg.sharded_edge_contributions(n, e, jmesh8))(noisy, edges)
    tH, tb = tdg.sharded_edge_contributions(_pose(noisy), _edges(edges), tmesh8)
    # 1e-4 of the information's scale: the two packages' float32 Jacobians
    # differ by ~1e-5 relative (at unit information this is JAX's 1e-4)
    tol = 1e-4 * info_scale
    np.testing.assert_allclose(tH.numpy(), np.asarray(H), rtol=0, atol=tol)
    np.testing.assert_allclose(tb.numpy(), np.asarray(b), rtol=0, atol=tol)
    # against the port's own single-shard assembly (the same per-edge bits,
    # summed in another order): JAX's own 1e-4 at either scale
    H1, b1 = tpg.edge_contributions(_pose(noisy), _edges(edges))
    np.testing.assert_allclose(tH.numpy(), H1.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tb.numpy(), b1.numpy(), rtol=0, atol=1e-4)


def _problem(n, seed, capacity, cross=False):
    gt = circle_poses(n)
    rng = np.random.RandomState(seed)
    drift = jse3.se3_exp(jnp.asarray(np.cumsum(rng.randn(n, 6) * 0.02, 0), jnp.float32))
    noisy = jse3.normalize(jse3.compose(gt, drift))
    edges = build_chain_edges(gt, capacity=capacity, close_loop=True)
    if cross:   # a chunk-crossing loop closure
        edges = jpg.add_edge(edges, 5, 21, jse3.relative(jse3.index(gt, 5), jse3.index(gt, 21)),
                             100 * jnp.eye(6))
    return noisy, edges, jnp.ones(n, bool)


_CASES = {
    "direct-gn": dict(n=12, seed=1, capacity=16, mode="gn", kw={}),
    "direct-lm": dict(n=12, seed=1, capacity=16, mode="lm", kw={}),
    "pcg-lm": dict(n=12, seed=9, capacity=16, mode="lm",
                   kw=dict(linear_solver="pcg", cg_iterations=100)),
    "schur-lm": dict(n=32, seed=21, capacity=64, mode="lm", cross=True,
                     kw=dict(linear_solver="schur", sep_capacity=24)),
    "schur-overflow": dict(n=32, seed=22, capacity=64, mode="lm", cross=True, iterations=8,
                           kw=dict(linear_solver="schur", sep_capacity=4)),
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_dist_optimize_matches_jax(name, jmesh8, tmesh8):
    c = _CASES[name]
    noisy, edges, mask = _problem(c["n"], c["seed"], c["capacity"], c.get("cross", False))
    its = c.get("iterations", 10)
    want, wstats = jax.jit(lambda n, e, m: jdg.optimize(
        n, e, m, jmesh8, iterations=its, mode=c["mode"], **c["kw"]))(noisy, edges, mask)
    got, gstats = tdg.optimize(_pose(noisy), _edges(edges), _t(mask), tmesh8, iterations=its,
                               mode=c["mode"], **c["kw"])
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0, atol=1e-3)
    np.testing.assert_allclose(float(gstats.final_cost), float(wstats.final_cost),
                               rtol=1e-2, atol=1e-5)
    assert float(gstats.final_cost) < float(gstats.initial_cost) * 1e-3
    if name == "schur-overflow":
        # the fallback's answer is the replicated direct solve's
        ref, _ = tpg.optimize(_pose(noisy), _edges(edges), _t(mask), iterations=its, mode="lm")
        np.testing.assert_allclose(got.t.numpy(), ref.t.numpy(), rtol=0, atol=5e-3)


def test_dist_schur_needs_divisible_nodes(tmesh8):
    noisy, edges, mask = _problem(12, 1, 16)
    with pytest.raises(ValueError, match="divide"):
        tdg.optimize(_pose(noisy), _edges(edges), _t(mask), tmesh8, linear_solver="schur")


def test_chain_poses_matches_jax():
    rng = np.random.RandomState(3)
    rel = jse3.se3_exp(jnp.asarray(rng.randn(6, 6) * 0.2, jnp.float32))
    base = jse3.se3_exp(jnp.asarray(rng.randn(6) * 0.5, jnp.float32))
    want = jax.jit(jds.chain_poses)(rel, base)
    got = tds.chain_poses(_pose(rel), _pose(base))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q), rtol=0, atol=1e-5)
    ones = tds.chain_poses(Pose(t=torch.tensor([[1.0, 0, 0]] * 4), q=torch.tensor(
        [[1.0, 0, 0, 0]] * 4)), Pose(t=torch.zeros(3), q=torch.tensor([1.0, 0, 0, 0])))
    np.testing.assert_allclose(ones.t.numpy()[:, 0], [0, 1, 2, 3, 4], atol=1e-6)


def test_batched_slam_step_matches_jax(jmesh8, tmesh8):
    B = 7
    world = jsyn.make_room_world(seed=0, n_points=8000)
    gt = jsyn.make_loop_trajectory(n_poses=B + 1, radius=5.0, laps=0.08)
    scans = [jsyn.render_scan(world, np.asarray(gt.t[i]), np.asarray(gt.q[i]), n_points=600,
                              noise=0.01, seed=i) for i in range(B + 1)]
    clouds = [jpc.from_points(s, capacity=1024) for s in scans]
    src = [np.stack([np.asarray(getattr(c, f)) for c in clouds[1:]]) for f in ("points", "mask")]
    tgt = [np.stack([np.asarray(getattr(c, f)) for c in clouds[:-1]]) for f in ("points", "mask")]
    want = jds.make_batched_step(JIcpConfig(mode="point", max_iterations=15), jmesh8)(
        *(jnp.asarray(x) for x in src + tgt))
    step = tds.make_batched_step(IcpConfig(mode="point", max_iterations=15), tmesh8)
    got = step(*(_t(x) for x in src + tgt))
    np.testing.assert_allclose(got.rel_poses.t.numpy(), np.asarray(want.rel_poses.t),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.rel_poses.q.numpy(), np.asarray(want.rel_poses.q),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.nodes.t.numpy(), np.asarray(want.nodes.t), rtol=0, atol=1e-3)
    assert got.nodes.t.shape == (B + 1, 3) and np.isfinite(float(got.final_cost))
    # the chained trajectory follows the ground truth (relative)
    gt_rel = jse3.relative(jse3.index(gt, 0), jse3.index(gt, B))
    est_rel = tse3.relative(tse3.index(got.nodes, 0), tse3.index(got.nodes, B))
    err = float(np.linalg.norm(est_rel.t.numpy() - np.asarray(gt_rel.t)))
    assert err < 0.5, err


# ---- the streaming step with the dist-* solvers -------------------------


def _cfg(backend="voxel", shards=1, **over):
    base = dict(
        voxel_leaf_size=0.3, map_resolution=0.3,
        icp_odometry=IcpConfig(mode="plane", max_iterations=8),
        icp_mapping=IcpConfig(mode="point", max_iterations=15),
        max_points=1024, max_raw_points=2048, max_map_points=8192,
        max_keyframes=32, max_edges=128, keyframes_window=4,
        map_backend=backend, map_shards=shards,
    )
    base.update(over)
    return tiny_config(**base)


def _stream(n_poses=14, laps=0.75):
    world = tsyn.make_room_world(seed=0, n_points=12000)
    gt = tsyn.make_loop_trajectory(n_poses=n_poses, radius=5.0, laps=laps)
    scans = [PointCloud(torch.from_numpy(p), torch.from_numpy(m))
             for p, m in tsyn.scan_stream(world, gt, capacity=2048, max_range=12.0,
                                          n_points=1200, noise=0.01)]
    return scans, gt


def _drive(cfg, stream, mesh=None):
    scans, gt = stream
    st = tslam.init_state(cfg, Pose(torch.from_numpy(gt[0][0]), torch.from_numpy(gt[1][0])),
                          device="cpu")
    poses = []
    for s in scans:
        st, out = tslam.slam_step(st, s, cfg, mesh=mesh)
        poses.append(out.pose_map.t)
    return st, torch.stack(poses)


@pytest.mark.parametrize("solver,n_poses,laps,tol", [("dist-direct", 14, 0.75, 1e-3),
                                                     ("dist-schur", 10, 0.5, 2e-3)])
def test_streaming_dist_solver_matches_replicated(solver, n_poses, laps, tol, tmesh8):
    stream = _stream(n_poses, laps)
    st_r, traj_r = _drive(_cfg(graph_incremental=False, graph_linear_solver="direct"), stream)
    calls = tdg.optimize.calls
    st_d, traj_d = _drive(_cfg(graph_incremental=False, graph_linear_solver=solver), stream,
                          tmesh8)
    assert int(st_d.num_optimizations) == int(st_r.num_optimizations) >= 1
    assert tdg.optimize.calls - calls == int(st_d.num_optimizations)
    np.testing.assert_allclose(traj_d.numpy(), traj_r.numpy(), rtol=0, atol=tol)


def test_streaming_dist_pcg_with_sharded_map(tmesh8):
    stream = _stream()
    cfg = _cfg("sharded", 8, graph_linear_solver="dist-pcg", loop_closure_min_id_gap=6)
    st, traj = _drive(cfg, stream, tmesh8)
    assert int(st.num_optimizations) >= 1
    assert torch.isfinite(st.slam_pose.t).all()
    err = np.linalg.norm(traj.numpy() - stream[1][0][: traj.shape[0]], axis=-1)
    assert err.max() < 0.6, err.max()


@pytest.mark.parametrize("over,mesh_size,match", [
    (dict(map_backend="sharded", map_shards=8), None, "requires a mesh"),
    (dict(map_backend="sharded", map_shards=8), 4, "map_shards"),
    (dict(graph_linear_solver="dist-pcg"), None, "requires a mesh"),
])
def test_mesh_value_errors_as_jax(over, mesh_size, match):
    cfg = _cfg(**over)
    state = tslam.init_state(cfg, device="cpu")   # no mesh needed, as in JAX
    mesh = None if mesh_size is None else tmesh_lib.make_mesh(mesh_size, device="cpu")
    scans, _ = _stream(2, 0.1)
    with pytest.raises(ValueError, match=match):
        tslam.slam_step(state, scans[0], cfg, mesh=mesh)


def test_deferred_dist_solver_needs_a_mesh(tmesh8):
    cfg = _cfg(graph_linear_solver="dist-direct", defer_optimization=True)
    with pytest.raises(ValueError, match="mesh"):
        tdeferred.DeferredBackend(cfg)
    assert tdeferred.DeferredBackend(cfg, mesh=tmesh8).mesh is tmesh8


def test_unknown_options_are_refused():
    for over in (dict(map_backend="octree"), dict(graph_linear_solver="dist-lu")):
        with pytest.raises(ValueError):
            tslam.init_state(dataclasses.replace(_cfg(), **over), device="cpu")


def test_scaling_ladder_format_and_efficiency_math():
    rungs = tscaling.measure_scaling([1, 2], pairs_per_device=1, n_points=500, capacity=1024,
                                     repeats=1, solver_nodes=8, icp_mode="point", device="cpu")
    assert [r["devices"] for r in rungs] == [1, 2]
    assert rungs[0]["efficiency"] == 1.0
    for r in rungs:
        assert r["scans_per_sec"] > 0
        assert r["pairs"] == r["devices"]   # weak scaling: 1 pair per shard
        assert set(r["solve_ms"]) == {"direct", "pcg", "schur"}
        assert all(v > 0 for v in r["solve_ms"].values())
        assert r["compute_ms"] > 0 and r["collective_ms"] >= 0
        assert 0.0 <= r["collective_frac"] < 1.0
    expect = (rungs[1]["scans_per_sec"] / 2) / rungs[0]["scans_per_sec"]
    assert abs(rungs[1]["efficiency"] - expect) < 1e-3
    assert tdg.ABLATE_COLLECTIVES is False
