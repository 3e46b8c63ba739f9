"""The port's voxel map (``mapping/voxel_map.py``) and its backend branch
against the JAX package on the CPU.

- The order: ``lexsort_order`` equals JAX's on int32 coordinates far
  beyond the ±1,024 cells of the scan filter's packed key, negative ones,
  duplicates and ``SENTINEL`` rows — exactly, both sorts being stable.
- Insert, first wins, overflow, the sorted invariant, ``lookup`` and
  ``approx_nn`` on clouds 2 km from the origin (5,000 cells at 0.4 m): the
  keys, sizes, overflow counts, hits and slots equal; the points within
  5e-4 m (the port's voxel filter sums its centroids in float64, JAX's in
  float32: ~1 ulp at 2 km is 1.2e-4 m).
- ``refine_and_grow`` and ``slam_step`` with ``map_backend='voxel'`` and
  a plane-mode mapper, whose target covariances come from the NN cloud:
  per step from a shared state (the JAX state carried into the port,
  ``utils/interop.py``), flags identical, the pose within 1e-3 m and
  1e-3 rad and the map size within 0.5% (the room-loop tolerances of
  ``tests/test_torch_slam.py``).
"""

import torch

# one intra-op thread per test worker: the suite runs several pytest
# workers on the host's cores beside XLA's own pool
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from icpslam_tpu.cloud import pointcloud as jpc
from icpslam_tpu.cloud.voxel import SENTINEL
from icpslam_tpu.cloud.voxel import lexsort_order as jlexsort
from icpslam_tpu.config import IcpConfig, tiny_config
from icpslam_tpu.geometry import se3 as jse3
from icpslam_tpu.mapping import scan_to_map as jstm
from icpslam_tpu.mapping import voxel_map as jvm
from icpslam_tpu.pipeline import slam as jslam
from icpslam_tpu_torch.cloud import pointcloud as tpc
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.io import synthetic as tsyn
from icpslam_tpu_torch.mapping import backend as tbackend
from icpslam_tpu_torch.mapping import scan_to_map as tstm
from icpslam_tpu_torch.mapping import voxel_map as tvm
from icpslam_tpu_torch.pipeline import slam as tslam
from icpslam_tpu_torch.utils import interop

RES = 0.4
FAR = np.array([2000.0, -1500.0, 3.0], np.float32)


def test_lexsort_order_matches_jax():
    rng = np.random.RandomState(0)
    n = 3000
    coords = np.concatenate([
        rng.randint(-(2**24), 2**24, (n, 3)),
        rng.randint(-1100, 1100, (n, 3)),           # the packed key's edge, ±1,024
        rng.randint(-3, 3, (n, 3)),                 # many duplicates
        np.full((200, 3), SENTINEL),
        np.array([[2**24 - 1, 2**24 - 1, 2**24 - 1], [-(2**24), SENTINEL, 0],
                  [SENTINEL, -(2**24), -(2**24)], [0, 0, SENTINEL]]),
    ]).astype(np.int32)
    coords = coords[rng.permutation(coords.shape[0])]
    got = tvm.lexsort_order(torch.from_numpy(coords)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jlexsort(jnp.asarray(coords))))
    s = coords[got]
    # JAX's own comparison never finds a row below its predecessor
    assert not np.asarray(jvm._lex_less(jnp.asarray(s[1:]), jnp.asarray(s[:-1]))).any()
    assert (s[-200:] == SENTINEL).all() or (s[-1] == SENTINEL).all()


def _far_clouds(n_clouds=4, n=1500, seed=1):
    """Map-frame clouds 2 km from the origin, overlapping each other."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(-12, 12, (n, 3)).astype(np.float32) * np.array([1, 1, 0.2], np.float32)
    out = []
    for k in range(n_clouds):
        pts = base + FAR + np.float32(1.3 * k) * np.array([1, 0.5, 0], np.float32)
        pts = pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)
        mask = np.ones(n + 100, bool)
        mask[n:] = False
        pts = np.concatenate([pts, np.zeros((100, 3), np.float32)])
        out.append((pts, mask))
    return out


def _both_maps(capacity, clouds):
    jm, tm = jvm.empty_map(capacity), tvm.empty_map(capacity, device="cpu")
    states = []
    for pts, mask in clouds:
        jm = jvm.insert(jm, jpc.PointCloud(jnp.asarray(pts), jnp.asarray(mask)), RES)
        tm = tvm.insert(tm, tpc.PointCloud(torch.from_numpy(pts), torch.from_numpy(mask)), RES)
        states.append((jm, tm))
    return states


def _assert_maps_equal(jm, tm):
    size = int(jm.size)
    assert int(tm.size) == size and int(tm.overflow) == int(jm.overflow)
    np.testing.assert_array_equal(tm.keys.numpy(), np.asarray(jm.keys))
    np.testing.assert_allclose(tm.points.numpy()[:size], np.asarray(jm.points)[:size],
                               rtol=0, atol=5e-4)


@pytest.mark.parametrize("capacity", [8192, 2500], ids=["room", "overflow"])
def test_insert_matches_jax(capacity):
    states = _both_maps(capacity, _far_clouds())
    for jm, tm in states:
        _assert_maps_equal(jm, tm)
    jm, tm = states[-1]
    size = int(tm.size)
    keys = tm.keys.numpy()
    # sorted, unique live keys beyond the packed key's range; SENTINEL after
    assert np.abs(keys[:size]).max() > 4096
    live = keys[:size]
    assert np.asarray(jvm._lex_less(jnp.asarray(live[:-1]), jnp.asarray(live[1:]))).all()
    assert (keys[size:] == SENTINEL).all()
    if capacity == 2500:
        assert size == capacity and int(tm.overflow) > 0
    else:
        assert int(tm.overflow) == 0 and size < capacity


def test_insert_first_wins():
    (pts, mask), = _far_clouds(1)
    m0 = tvm.insert(tvm.empty_map(4096, device="cpu"),
                    tpc.PointCloud(torch.from_numpy(pts), torch.from_numpy(mask)), RES)
    moved = pts + np.float32(0.01)  # mostly the same voxels, other points
    m1 = tvm.insert(m0, tpc.PointCloud(torch.from_numpy(moved), torch.from_numpy(mask)), RES)
    jm0 = jvm.insert(jvm.empty_map(4096), jpc.PointCloud(jnp.asarray(pts), jnp.asarray(mask)), RES)
    jm1 = jvm.insert(jm0, jpc.PointCloud(jnp.asarray(moved), jnp.asarray(mask)), RES)
    _assert_maps_equal(jm1, m1)
    found, idx = tvm.lookup(m1, m0.keys[: int(m0.size)])
    assert found.all()
    # every voxel already held keeps the point it had
    np.testing.assert_array_equal(m1.points[idx].numpy(), m0.points[: int(m0.size)].numpy())


def test_lookup_matches_jax():
    jm, tm = _both_maps(8192, _far_clouds())[-1]
    rng = np.random.RandomState(3)
    size = int(tm.size)
    held = tm.keys.numpy()[rng.randint(0, size, 500)]
    q = np.concatenate([held, held + rng.randint(-2, 3, held.shape),
                        np.full((5, 3), SENTINEL), rng.randint(-2**20, 2**20, (50, 3))]).astype(np.int32)
    hit, idx = tvm.lookup(tm, torch.from_numpy(q))
    jhit, jidx = jvm.lookup(jm, jnp.asarray(q))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert hit.numpy()[:500].all() and not hit.numpy()[-55:].any()


@pytest.mark.parametrize("radius", [1, 2])
def test_approx_nn_matches_jax(radius):
    jm, tm = _both_maps(8192, _far_clouds())[-1]
    rng = np.random.RandomState(4)
    q = (FAR + rng.uniform(-15, 15, (700, 3)) * np.array([1, 1, 0.2])).astype(np.float32)
    mask = rng.uniform(size=700) > 0.1
    got = tvm.approx_nn(tm, torch.from_numpy(q), torch.from_numpy(mask), RES, radius=radius)
    ref = jvm.approx_nn(jm, jnp.asarray(q), jnp.asarray(mask), RES, radius=radius)
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(ref.found))
    assert got.found.numpy().any() and not got.found.numpy().all()
    f = got.found.numpy()
    np.testing.assert_allclose(got.points.numpy()[f], np.asarray(ref.points)[f], rtol=0, atol=5e-4)
    # d² of the same neighbour, from points 5e-4 apart at ≤ 2 cells
    np.testing.assert_allclose(got.dist2.numpy()[f], np.asarray(ref.dist2)[f], rtol=0, atol=2e-3)
    assert np.isinf(got.dist2.numpy()[~f]).all()


CFG = tiny_config(
    voxel_leaf_size=0.3,
    map_resolution=0.3,
    icp_odometry=IcpConfig(mode="plane", max_iterations=10),
    icp_mapping=IcpConfig(mode="plane", max_iterations=20),
    max_points=512,
    max_raw_points=1024,
    max_map_points=4096,
    max_keyframes=16,
    max_edges=64,
    keyframe_distance=0.3,
    keyframes_window=4,
    enable_loop_closure=False,
    map_backend="voxel",
)
N_SCANS = 7
FLAGS = {"accepted": 7, "refined": 11, "new_keyframe": 12, "optimized": 14,
         "num_keyframes": 16}


@pytest.fixture(scope="module")
def mission():
    world = tsyn.make_room_world(0, 12000)
    gt_t, gt_q = tsyn.make_loop_trajectory(n_poses=24, radius=3.0)
    scans = list(tsyn.scan_stream(world, (gt_t[:N_SCANS], gt_q[:N_SCANS]),
                                  capacity=CFG.max_raw_points, max_range=12.0, n_points=1000,
                                  noise=0.01, seed=1))
    step = jax.jit(jslam.slam_step, static_argnums=(2,))
    j_state = jslam.init_state(CFG, initial_pose=jse3.Pose(t=gt_t[0], q=gt_q[0]))
    rec = {"jax": [], "step": []}
    states = []
    for pts, mask in scans:
        shared_np = jax.tree_util.tree_map(np.asarray, j_state)
        states.append(shared_np)
        shared = interop.state_from_numpy(shared_np, device="cpu")
        assert isinstance(shared.map, tvm.VoxelMap)
        j_state, jo = step(j_state, jpc.PointCloud(points=pts, mask=mask), CFG)
        _, so = tslam.slam_step(shared, tpc.PointCloud(torch.tensor(pts), torch.tensor(mask)), CFG)
        rec["jax"].append(np.asarray(jo.packed))
        rec["step"].append(so.packed.numpy())
    return {k: np.stack(v) for k, v in rec.items()}, states


def test_slam_step_voxel_flags_and_pose(mission):
    rec, _ = mission
    assert rec["jax"][:, FLAGS["refined"]].sum() >= 3
    assert rec["jax"][:, FLAGS["optimized"]].sum() >= 1
    for name, col in FLAGS.items():
        np.testing.assert_array_equal(rec["step"][:, col], rec["jax"][:, col], err_msg=name)
    dt = np.linalg.norm(rec["step"][:, :3] - rec["jax"][:, :3], axis=-1)
    assert dt.max() <= 1e-3, dt
    d = np.abs(np.sum(rec["step"][:, 3:7].astype(np.float64) * rec["jax"][:, 3:7], -1))
    assert (2.0 * np.arccos(np.clip(d, 0.0, 1.0))).max() <= 1e-3
    j, s = rec["jax"][:, 15], rec["step"][:, 15]
    assert np.all(np.abs(s - j) <= 0.005 * j), (s, j)


def test_refine_and_grow_voxel_matches_jax(mission):
    """One refinement against a voxel map carried from JAX: the NN cloud's
    covariances are recomputed (K2's plain version here) in both."""
    _, states = mission
    tree = states[-1]
    assert int(tree.map.size) > 0
    odo = tree.odom
    jmap = jvm.VoxelMap(*(jnp.asarray(x) for x in tree.map))
    tmap = interop.state_from_numpy(tree, device="cpu").map
    pose = jse3.Pose(t=jnp.asarray(tree.slam_pose.t) + 0.05, q=jnp.asarray(tree.slam_pose.q))
    jscan = jpc.PointCloud(jnp.asarray(odo.prev_cloud.points), jnp.asarray(odo.prev_cloud.mask))
    jr = jstm.refine_and_grow(jmap, jscan, pose, CFG)
    tr = tstm.refine_and_grow(
        tmap, tpc.PointCloud(torch.tensor(odo.prev_cloud.points), torch.tensor(odo.prev_cloud.mask)),
        Pose(torch.tensor(np.asarray(pose.t)), torch.tensor(np.asarray(pose.q))),
        CFG, map_empty=False)
    assert bool(jr.success) and bool(tr.success)
    assert int(tr.nn_found) == int(jr.nn_found)
    np.testing.assert_allclose(tr.refined_pose.t.numpy(), np.asarray(jr.refined_pose.t), atol=1e-3)
    np.testing.assert_array_equal(tr.nn_mask.numpy(), np.asarray(jr.nn_mask))
    assert abs(int(tr.map.size) - int(jr.map.size)) <= 0.005 * int(jr.map.size)
    assert int(tbackend.total_overflow(tr.map)) == int(jr.map.overflow)


def test_state_round_trip_voxel(mission):
    _, states = mission
    tree = states[-1]
    back = interop.state_to_numpy(interop.state_from_numpy(tree, device="cpu"))
    assert type(back.map).__name__ == "VoxelMap"
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
