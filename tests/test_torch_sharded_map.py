"""The port's spatially sharded map (``parallel/sharded_map.py``), its
backend branch and the sharded streaming step, against the JAX package on
the CPU (the JAX side on the 8-virtual-device mesh of ``conftest.py``).

- ``owner_of`` equals JAX's bit for bit on random int32 coordinates,
  large negatives and INT32_MIN's block included (wrapping products,
  arithmetic shift, ``abs`` of INT32_MIN, floor modulo).
- ``insert`` at D = 8 and D = 4: per shard the same size, overflow and
  sorted keys; the points within 1e-5 m (the port's voxel filter sums its
  centroids in float64, JAX's in float32; these clouds lie within 8 m of
  the origin).
- ``approx_nn`` on JAX's map carried into the port: ``found`` equal, the
  points and d² within 1e-5, and on a query equidistant from two points
  in two shards the same winner (the lowest shard id) in both.
- The streaming step (the port only; JAX's sharded drive already spends
  minutes of the suite): at D = 1 the records equal the voxel backend's
  bit for bit; at D = 8 JAX's own assertions
  (``tests/test_sharded_slam.py``): the trajectory within 1e-4 m, the
  shard sizes summing to the voxel map's size and overflow, equal
  keyframe, optimization and loop-closure counts, every shard holding only
  the voxels it owns. A checkpoint of the sharded state loads across the
  packages with equal leaves, and ``rerender_map`` re-shards.
"""

import torch

# one intra-op thread per test worker: the suite runs several pytest
# workers on the host's cores beside XLA's own pool
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from icpslam_tpu import cloud as jpc
from icpslam_tpu.config import tiny_config as jtiny
from icpslam_tpu.parallel import mesh as jmesh_lib
from icpslam_tpu.parallel import sharded_map as jsm
from icpslam_tpu.pipeline import slam as jslam
from icpslam_tpu.utils import checkpoint as jckpt
from icpslam_tpu_torch.cloud.pointcloud import PointCloud
from icpslam_tpu_torch.config import IcpConfig, tiny_config
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.io import synthetic as tsyn
from icpslam_tpu_torch.mapping import backend as tbackend
from icpslam_tpu_torch.mapping import voxel_map as tvm
from icpslam_tpu_torch.parallel import mesh as tmesh_lib
from icpslam_tpu_torch.parallel import sharded_map as tsm
from icpslam_tpu_torch.pipeline import slam as tslam
from icpslam_tpu_torch.utils import checkpoint as tckpt

RES = 0.4


def _cloud(seed, n=300, lo=-6.0, hi=6.0, capacity=512):
    rng = np.random.RandomState(seed)
    pts = np.zeros((capacity, 3), np.float32)
    pts[:n] = rng.uniform(lo, hi, (n, 3))
    mask = np.arange(capacity) < n
    return pts, mask


def _both(pts, mask):
    return (jpc.PointCloud(points=jnp.asarray(pts), mask=jnp.asarray(mask)),
            PointCloud(torch.from_numpy(pts), torch.from_numpy(mask)))


def _tmesh(d):
    return tmesh_lib.make_mesh(d, device="cpu")


def test_owner_of_matches_jax_bit_for_bit():
    rng = np.random.RandomState(0)
    coords = np.concatenate([
        rng.randint(-(2**31), 2**31 - 1, (4000, 3), dtype=np.int64),
        rng.randint(-(2**24), 2**24, (4000, 3)),
        rng.randint(-300, 300, (4000, 3)),
        np.array([[-(2**31), -(2**31), -(2**31)], [2**31 - 1, -(2**31), 0],
                  [-1, -1, -1], [0, 0, 0], [-16, 15, -17]]),
    ]).astype(np.int32)
    for d in (1, 3, 4, 8):
        want = np.asarray(jsm.owner_of(jnp.asarray(coords), d))
        got = tsm.owner_of(torch.from_numpy(coords), d).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.min() >= 0 and got.max() < d


@pytest.mark.parametrize("d", [8, 4])
def test_insert_matches_jax_per_shard(d):
    jm = jmesh_lib.make_mesh(d)
    # jitted: JAX's eager shard_map takes minutes on the CPU
    jinsert = jax.jit(lambda m, c: jsm.insert(m, c, RES, jm))
    jmap = jsm.empty_sharded_map(256, d)
    tmap = tsm.empty_sharded_map(256, d, device="cpu")
    for seed in (0, 1):   # the second insert overlaps the first: dedup
        jc, tc = _both(*_cloud(seed, n=400))
        jmap = jinsert(jmap, jc)
        tmap = tsm.insert(tmap, tc, RES, _tmesh(d))
    np.testing.assert_array_equal(tmap.size.numpy(), np.asarray(jmap.size))
    np.testing.assert_array_equal(tmap.overflow.numpy(), np.asarray(jmap.overflow))
    np.testing.assert_array_equal(tmap.keys.numpy(), np.asarray(jmap.keys))
    np.testing.assert_allclose(tmap.points.numpy(), np.asarray(jmap.points), rtol=0, atol=1e-5)
    assert int(tsm.total_size(tmap)) == int(jsm.total_size(jmap))


def test_approx_nn_matches_jax_ties_included():
    d, res = 8, 0.5   # dyadic: the tie below is exact in float32
    jm = jmesh_lib.make_mesh(d)
    pts, mask = _cloud(3, n=400)
    # one point either side of the block face x = 16 voxels (8.0 m), alone
    # in its voxel, equidistant from a query on the face, in two shards
    pair = np.array([[7.75, 0.25, 0.25], [8.25, 0.25, 0.25]], np.float32)
    pts[400:402], mask[400:402] = pair, True
    owners = tsm.owner_of(torch.floor(torch.from_numpy(pair) / res).to(torch.int32), d)
    assert owners[0] != owners[1]
    jc, _ = _both(pts, mask)
    jmap = jax.jit(lambda m, c: jsm.insert(m, c, res, jm))(jsm.empty_sharded_map(512, d), jc)
    tmap = tvm.VoxelMap(*(torch.from_numpy(np.array(x)) for x in jmap))

    rng = np.random.RandomState(4)
    q = rng.uniform(-5, 7, (96, 3)).astype(np.float32)
    q[0] = [8.0, 0.25, 0.25]       # the tie
    q[1] = [8.125, 0.25, 0.25]     # nearer the second point
    qm = np.ones(96, bool)
    qm[5] = False
    want = jax.jit(lambda m, a, b: jsm.approx_nn(m, a, b, res, jm))(
        jmap, jnp.asarray(q), jnp.asarray(qm))
    got = tsm.approx_nn(tmap, torch.from_numpy(q), torch.from_numpy(qm), res, _tmesh(d))
    found = np.asarray(want.found)
    np.testing.assert_array_equal(got.found.numpy(), found)
    assert found[0] and found[1] and not found[5]
    np.testing.assert_allclose(got.dist2.numpy()[found], np.asarray(want.dist2)[found],
                               rtol=0, atol=1e-5)
    assert np.isinf(got.dist2.numpy()[~found]).all()
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), rtol=0, atol=1e-5)
    # the tie goes to the lowest shard id in both
    low = int(torch.argmin(owners))
    np.testing.assert_array_equal(np.asarray(want.points)[0], pair[low])
    np.testing.assert_array_equal(got.points.numpy()[0], pair[low])
    np.testing.assert_array_equal(got.points.numpy()[1], pair[1])


def test_empty_sharded_map_layout():
    cfg = tiny_config(map_backend="sharded", map_shards=8)
    m = tbackend.empty(cfg, device="cpu")
    assert tbackend.is_sharded(m)
    assert m.keys.shape == (8, cfg.max_map_points, 3) and m.size.shape == (8,)
    jm = jslam.init_state(jtiny(map_backend="sharded", map_shards=8)).map
    for a, b in zip(m, jm):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # each shard is its own memory (no broadcast views): a write to one
    # shard leaves the others as they were
    m.keys[0, 0, 0] = 7
    m.size[0] = 3
    assert (m.keys[1:, 0, 0] != 7).all() and (m.size[1:] == 0).all()


# ---- the streaming step -------------------------------------------------


def _cfg(backend, shards=1, **over):
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


@pytest.fixture(scope="module")
def stream():
    world = tsyn.make_room_world(seed=0, n_points=12000)
    gt = tsyn.make_loop_trajectory(n_poses=14, radius=5.0, laps=0.75)
    scans = [PointCloud(torch.from_numpy(p), torch.from_numpy(m))
             for p, m in tsyn.scan_stream(world, gt, capacity=2048, max_range=12.0,
                                          n_points=1200, noise=0.01)]
    return scans, gt


def _drive(cfg, stream, mesh=None):
    scans, gt = stream
    st = tslam.init_state(cfg, Pose(torch.from_numpy(gt[0][0]), torch.from_numpy(gt[1][0])),
                          device="cpu")
    recs = []
    for s in scans:
        st, out = tslam.slam_step(st, s, cfg, mesh=mesh)
        recs.append(out.packed)
    return st, torch.stack(recs)


@pytest.fixture(scope="module")
def voxel_run(stream):
    return _drive(_cfg("voxel"), stream)


def test_one_shard_equals_the_voxel_backend(stream, voxel_run):
    sv, rv = voxel_run
    s1, r1 = _drive(_cfg("sharded", 1), stream, _tmesh(1))
    assert torch.equal(r1, rv)
    assert s1.map.keys.shape[0] == 1
    for a, b in zip(s1.map, sv.map):
        assert torch.equal(a[0], b)


def test_eight_shards_match_the_voxel_backend(stream, voxel_run):
    sv, rv = voxel_run
    s8, r8 = _drive(_cfg("sharded", 8), stream, _tmesh(8))
    assert int(s8.keyframes.count) == int(sv.keyframes.count)
    np.testing.assert_allclose(r8[:, :3].numpy(), rv[:, :3].numpy(), rtol=0, atol=1e-4)
    assert int(s8.map.size.sum()) == int(sv.map.size)
    assert int(s8.map.overflow.sum()) == int(sv.map.overflow)
    assert int(s8.num_optimizations) == int(sv.num_optimizations)
    assert int(s8.num_loop_closures) == int(sv.num_loop_closures)
    keys, sizes = s8.map.keys.numpy(), s8.map.size.numpy()
    for d in range(8):
        live = keys[d, : sizes[d]]
        assert (tsm.owner_of(torch.from_numpy(live), 8).numpy() == d).all()
    # JAX's owner_of agrees on the live keys
    live = np.concatenate([keys[d, : sizes[d]] for d in range(8)])
    np.testing.assert_array_equal(np.asarray(jsm.owner_of(jnp.asarray(live), 8)),
                                  tsm.owner_of(torch.from_numpy(live), 8).numpy())


def _jax_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_sharded_checkpoint_crosses_packages_and_rerenders(stream, tmp_path):
    cfg = _cfg("sharded", 4)
    st, _ = _drive(cfg, stream, _tmesh(4))
    jcfg = jtiny(**{f: getattr(cfg, f) for f in (
        "voxel_leaf_size", "map_resolution", "max_points", "max_raw_points", "max_map_points",
        "max_keyframes", "max_edges", "keyframes_window", "map_backend", "map_shards")})
    port_file = str(tmp_path / "port.npz")
    tckpt.save(port_file, st)
    jleaves = _jax_leaves(jckpt.load(port_file, jslam.init_state(jcfg)))
    tleaves = dict(tckpt.leaves_with_paths(st))
    assert sorted(jleaves) == sorted(tleaves)
    for key, value in tleaves.items():
        np.testing.assert_array_equal(jleaves[key], value.numpy(), err_msg=key)
    assert jleaves[".map.keys"].shape == (4, cfg.max_map_points, 3)

    jax_file = str(tmp_path / "jax.npz")
    jckpt.save(jax_file, jckpt.load(port_file, jslam.init_state(jcfg)))
    back = tckpt.load(jax_file, tslam.init_state(cfg, device="cpu"))
    for key, value in tckpt.leaves_with_paths(back):
        assert torch.equal(value, tleaves[key]), key

    rer = tckpt.rerender_map(back, cfg, mesh=_tmesh(4))
    keys, sizes = rer.map.keys.numpy(), rer.map.size.numpy()
    assert sizes.sum() > 0
    for d in range(4):
        assert (tsm.owner_of(torch.from_numpy(keys[d, : sizes[d]]), 4).numpy() == d).all()
    with pytest.raises(ValueError, match="mesh"):
        tckpt.rerender_map(back, cfg)
