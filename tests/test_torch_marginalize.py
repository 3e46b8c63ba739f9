"""The port's keyframe marginalization against the JAX one
(``icpslam_tpu/graph/marginalize.py``), and a mission that outlives its
keyframe store through both packages.

Unit inputs are numpy arrays from a seed handed to both packages:
``compose_covariance`` and ``inverse_covariance`` within 1e-5 of the
largest entry; ``select_victim`` equal on stores whose scores are at
least 1e-3 apart (the gauge, the recent trail and the loop penalty each
decide one case); ``fuse_duplicate_edges`` on one pair and on a run of
three over two passes; ``marginalize_keyframe`` on a full store with a
loop edge into the victim, an edge out of it, a wheel twin of the hop
and an edge that re-homing duplicates. Indices, validity and counts are
equal; rel and info agree within 1e-4 of each edge's own size (rel_t:
its norm, plus 1e-6 m for float32 rounding; info: its largest entry).

The mission: 34 scans of a room loop (0.85 laps, 0.79 m a scan) under
``tiny_config(max_keyframes=12, keyframe_protect_recent=4,
graph_linear_solver="pcg", ...)``, so the store fills at the 12th scan,
every later scan evicts, and every graph solve runs PCG inside
``slam_step``. Per step, from JAX's state carried into the port
(``utils/interop.py``): the victim each package picks on that state is
the same (or one of JAX's two smallest scores, where they lie within
1e-5), and after the step the edges agree as above, the keyframe count
and evictions are equal, and the graph poses agree within 2e-3 m: a
graph solve moves float32 differences to ~1e-3 m in either package,
with the direct solver as with PCG. Then the port runs free: it evicts,
ends with a full store and an edge store that is a valid prefix.
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
from icpslam_tpu.config import tiny_config
from icpslam_tpu.geometry import se3 as jse3
from icpslam_tpu.graph import keyframes as jkf
from icpslam_tpu.graph import marginalize as jmarg
from icpslam_tpu.graph import pose_graph as jpg
from icpslam_tpu.pipeline import slam as jslam
from icpslam_tpu_torch import config as tconfig
from icpslam_tpu_torch.cloud import pointcloud as tpc
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.graph import keyframes as tkf
from icpslam_tpu_torch.graph import marginalize as tmarg
from icpslam_tpu_torch.graph import pose_graph as tpg
from icpslam_tpu_torch.io import synthetic as tsyn
from icpslam_tpu_torch.pipeline import slam as tslam
from icpslam_tpu_torch.utils import interop


def _quat(rng, n, scale):
    axis = rng.randn(n, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = rng.randn(n) * scale
    return np.c_[np.cos(ang / 2), axis * np.sin(ang / 2)[:, None]].astype(np.float32)


def _spd(rng, n, scale):
    A = rng.randn(n, 6, 6)
    return (scale * (A @ A.transpose(0, 2, 1) / 6 + 0.1 * np.eye(6))).astype(np.float32)


def _jpose(t, q):
    return jse3.Pose(t=jnp.asarray(t), q=jnp.asarray(q))


def _tpose(t, q):
    return Pose(t=torch.tensor(t), q=torch.tensor(q))


def test_covariance_algebra_matches_jax():
    rng = np.random.RandomState(0)
    ta, qa = (rng.randn(8, 3) * 2).astype(np.float32), _quat(rng, 8, 0.7)
    tb, qb = (rng.randn(8, 3) * 2).astype(np.float32), _quat(rng, 8, 0.7)
    Sa, Sb = _spd(rng, 8, 0.05), _spd(rng, 8, 0.01)
    want = np.asarray(jmarg.compose_covariance(_jpose(ta, qa), jnp.asarray(Sa),
                                               _jpose(tb, qb), jnp.asarray(Sb)))
    got = tmarg.compose_covariance(_tpose(ta, qa), torch.tensor(Sa), _tpose(tb, qb),
                                   torch.tensor(Sb)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    want = np.asarray(jmarg.inverse_covariance(_jpose(ta, qa), jnp.asarray(Sa)))
    got = tmarg.inverse_covariance(_tpose(ta, qa), torch.tensor(Sa)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


K, N_PTS, E = 10, 8, 32


def _store(rng, spacing, count=K):
    """A numpy keyframe store (JAX field order) along the x axis with the
    given gaps between consecutive keyframes."""
    x = np.concatenate([[0.0], np.cumsum(spacing)]).astype(np.float32)
    t = np.c_[x, 0.1 * np.sin(x), np.zeros_like(x)].astype(np.float32)
    q = _quat(rng, K, 0.1)
    pts = rng.randn(K, N_PTS, 3).astype(np.float32)
    cov = _spd(rng, K, 0.01)
    cov[2] = 0.0  # a keyframe without a stored covariance
    return jkf.KeyframeStore(
        pose_odom=jse3.Pose(t=t + 0.01, q=q), pose_graph=jse3.Pose(t=t, q=q),
        stamp=np.arange(K, dtype=np.float32), points=pts,
        point_mask=rng.rand(K, N_PTS) < 0.8, cov=cov,
        count=np.int32(count), evictions=np.int32(3),
    )


def _edges(rng, store, pairs, infos):
    """A numpy edge set: ``pairs`` measured from the store's graph poses
    with noise, information ``infos`` (one 6×6 per pair), padded to E."""
    n = len(pairs)
    ei = np.zeros(E, np.int32)
    ej = np.zeros(E, np.int32)
    ei[:n], ej[:n] = np.array(pairs, np.int32).T
    g = store.pose_graph
    rel = jse3.relative(_jpose(g.t[ei], g.q[ei]), _jpose(g.t[ej], g.q[ej]))
    rel = jse3.normalize(jse3.compose(
        rel, jse3.se3_exp(jnp.asarray(rng.randn(E, 6).astype(np.float32) * 0.01))))
    info = np.tile(np.eye(6, dtype=np.float32), (E, 1, 1))
    info[:n] = infos
    return jpg.EdgeSet(
        i=ei, j=ej, rel_t=np.asarray(rel.t), rel_q=np.asarray(rel.q), info=info,
        valid=np.arange(E) < n, count=np.int32(n), overflow=np.int32(2),
    )


_PORT_TYPES = {"KeyframeStore": tkf.KeyframeStore, "EdgeSet": tpg.EdgeSet}


def _to_port(tree):
    """The port's store or edge set from the JAX one, on the CPU."""
    return interop._build(_PORT_TYPES[type(tree).__name__], tree, "cpu")


def _assert_edges_close(got, want):
    """i, j, valid and count equal; rel and info within 1e-4 of each
    edge's own size."""
    got = interop.state_to_numpy(got)
    want = jax.tree_util.tree_map(np.asarray, want)
    assert int(got.count) == int(want.count)
    assert int(got.overflow) == int(want.overflow)
    np.testing.assert_array_equal(got.valid, want.valid)
    live = want.valid
    np.testing.assert_array_equal(got.i[live], want.i[live])
    np.testing.assert_array_equal(got.j[live], want.j[live])
    norm = np.linalg.norm(want.rel_t[live], axis=-1, keepdims=True)
    assert np.all(np.abs(got.rel_t[live] - want.rel_t[live]) <= 1e-4 * norm + 1e-6)
    np.testing.assert_allclose(got.rel_q[live], want.rel_q[live], rtol=0, atol=1e-4)
    scale = np.abs(want.info[live]).max(axis=(1, 2), keepdims=True)
    assert np.all(np.abs(got.info[live] - want.info[live]) <= 1e-4 * scale)


_VICTIM_CASES = {
    # the tightest spot is at node 0 (the gauge): node 6 is next
    "gauge": dict(spacing=[0.1, 0.5, 0.9, 0.8, 0.7, 0.3, 0.25, 1.1, 1.2], loops=[], protect=3),
    # the tightest spot is in the recent trail: node 3 is next
    "recent": dict(spacing=[1.0, 0.9, 0.3, 0.35, 0.8, 0.7, 0.9, 0.1, 0.1], loops=[], protect=3),
    # the tightest spot (node 3) anchors a loop edge: node 6 is next
    "loop penalty": dict(spacing=[1.0, 0.9, 0.2, 0.3, 0.9, 0.25, 0.3, 1.0, 1.1],
                         loops=[(3, 8)], protect=1),
}


@pytest.mark.parametrize("case", sorted(_VICTIM_CASES))
def test_select_victim_matches_jax(case):
    c = _VICTIM_CASES[case]
    rng = np.random.RandomState(1)
    store = _store(rng, c["spacing"])
    pairs = [(k, k + 1) for k in range(K - 1)] + c["loops"]
    edges = _edges(rng, store, pairs, np.tile(100 * np.eye(6, dtype=np.float32), (len(pairs), 1, 1)))
    # the scores are at least 1e-3 apart, so float rounding cannot tie them
    t = store.pose_graph.t
    ids = np.arange(K)
    base = (np.linalg.norm(t - t[np.maximum(ids - 1, 0)], axis=-1)
            + np.linalg.norm(t[np.minimum(ids + 1, K - 1)] - t, axis=-1))
    score = base.copy()
    for a, b in c["loops"]:
        score[a] += 10.0
        score[b] += 10.0
    s = np.sort(score[1: K - c["protect"]])
    assert np.diff(s).min() >= 1e-3
    want = int(jmarg.select_victim(store, edges, protect_recent=c["protect"]))
    got = tmarg.select_victim(_to_port(store), _to_port(edges), protect_recent=c["protect"])
    assert got.dtype == torch.int32 and int(got) == want
    assert want != int(np.argmin(base))  # the protection or the penalty decided it


def _dup_edges(rng, runs):
    """Edges with ``runs[(i, j)]`` parallel copies each (in shuffled
    slots), different measurements and informations."""
    store = _store(rng, [0.8] * (K - 1))
    pairs = [p for p, n in runs.items() for _ in range(n)]
    perm = rng.permutation(len(pairs))
    pairs = [pairs[k] for k in perm]
    return _edges(rng, store, pairs, _spd(rng, len(pairs), 100.0))


@pytest.mark.parametrize("runs", [{(2, 3): 2, (4, 5): 1, (0, 7): 1},
                                  {(2, 3): 3, (4, 5): 1, (1, 6): 2}], ids=["one-pair", "run-of-three"])
def test_fuse_duplicate_edges_matches_jax(runs):
    rng = np.random.RandomState(2)
    edges = _dup_edges(rng, runs)
    j_out, t_out = edges, _to_port(edges)
    for _ in range(2):
        j_out = jmarg.fuse_duplicate_edges(j_out)
        t_out = tmarg.fuse_duplicate_edges(t_out)
        _assert_edges_close(t_out, j_out)
    # two passes leave one edge per pair
    assert int(t_out.count) == len(runs)


def test_marginalize_keyframe_matches_jax():
    rng = np.random.RandomState(3)
    store = _store(rng, [0.8, 0.7, 0.9, 0.6, 0.8, 0.7, 0.9, 0.8, 0.7])
    v = 4
    pairs = [(k, k + 1) for k in range(K - 1)]
    pairs += [(3, 4), (0, 4), (4, 9), (3, 5), (1, 8)]  # wheel twin, loop in, loop out, duplicate-to-be
    infos = _spd(rng, len(pairs), 200.0)
    infos[len(pairs) - 5] = 10.0 * np.eye(6)  # the wheel twin, weaker than the ICP hop
    edges = _edges(rng, store, pairs, infos)
    j_store, j_edges = jmarg.marginalize_keyframe(store, edges, jnp.asarray(v, jnp.int32))
    t_store, t_edges = tmarg.marginalize_keyframe(_to_port(store), _to_port(edges),
                                                  torch.tensor(v, dtype=torch.int32))
    _assert_edges_close(t_edges, j_edges)
    # the hop and its twin dropped, (3,5) fused with the re-homed (4,5)
    assert int(t_edges.count) == len(pairs) - 3
    got = interop.state_to_numpy(t_store)
    want = jax.tree_util.tree_map(np.asarray, j_store)
    for name in ("stamp", "points", "point_mask", "cov", "count", "evictions"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    for name in ("pose_odom", "pose_graph"):
        np.testing.assert_array_equal(getattr(got, name).t, getattr(want, name).t)
        np.testing.assert_array_equal(getattr(got, name).q, getattr(want, name).q)
    # without a measured hop, the graph estimate and the victim's stored
    # covariance (node 2's is zero: 1e-2·I instead)
    keep = ~(((edges.i == 3) & (edges.j == 4)) | ((edges.i == 1) & (edges.j == 2)))
    no_hop = edges._replace(valid=edges.valid & keep)
    for victim in (v, 2):
        j_store, j_edges = jmarg.marginalize_keyframe(store, no_hop, jnp.asarray(victim, jnp.int32))
        t_store, t_edges = tmarg.marginalize_keyframe(_to_port(store), _to_port(no_hop),
                                                      torch.tensor(victim, dtype=torch.int32))
        _assert_edges_close(t_edges, j_edges)


# ---------------------------------------------------------------------------
# the mission
# ---------------------------------------------------------------------------

MISSION = dict(
    max_keyframes=12, keyframe_protect_recent=4, max_edges=64, keyframe_distance=0.25,
    max_raw_points=2048, max_points=512, max_map_points=8192, graph_linear_solver="pcg",
    voxel_leaf_size=0.3, map_resolution=0.3,
)
CFG = tiny_config(**MISSION)
TCFG = tconfig.tiny_config(**MISSION)
N_SCANS = 34


def _scores(store, edges, protect):
    """JAX's victim scores, in numpy."""
    t, count = store.pose_graph.t, int(store.count)
    ids = np.arange(t.shape[0])
    score = (np.linalg.norm(t - t[np.maximum(ids - 1, 0)], axis=-1)
             + np.linalg.norm(t[np.minimum(ids + 1, t.shape[0] - 1)] - t, axis=-1))
    loop = edges.valid & ((edges.j - edges.i) > 1)
    np.add.at(score, edges.i[loop], 10.0)
    np.add.at(score, edges.j[loop], 10.0)
    score[(ids == 0) | (ids >= count - protect)] = np.inf
    return score


@pytest.fixture(scope="module")
def mission():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(TCFG)
    world = tsyn.make_room_world(0, 12000)
    gt_t, gt_q = tsyn.make_loop_trajectory(n_poses=N_SCANS, radius=5.0, laps=0.85)
    scans = list(tsyn.scan_stream(world, (gt_t, gt_q), capacity=CFG.max_raw_points,
                                  max_range=12.0, n_points=1000, noise=0.01, seed=1))
    step = jax.jit(jslam.slam_step, static_argnums=(2,))
    j_state = jslam.init_state(CFG, initial_pose=jse3.Pose(t=gt_t[0], q=gt_q[0]))
    free = tslam.init_state(TCFG, initial_pose=_tpose(gt_t[0], gt_q[0]), device="cpu")
    steps, victims = [], []
    pcg0 = tpg.optimize.pcg_solves
    for pts, mask in scans:
        before = jax.tree_util.tree_map(np.asarray, j_state)
        shared = interop.state_from_numpy(before, device="cpu")
        port_scan = tpc.PointCloud(torch.tensor(pts), torch.tensor(mask))
        j_state, jo = step(j_state, jpc.PointCloud(points=pts, mask=mask), CFG)
        port, _ = tslam.slam_step(shared, port_scan, TCFG)
        free, _ = tslam.slam_step(free, port_scan, TCFG)
        if int(before.keyframes.count) == CFG.max_keyframes and bool(jo.new_keyframe):
            score = _scores(before.keyframes, before.edges, CFG.keyframe_protect_recent)
            want = int(jmarg.select_victim(before.keyframes, before.edges,
                                           protect_recent=CFG.keyframe_protect_recent))
            got = int(tmarg.select_victim(shared.keyframes, shared.edges,
                                          protect_recent=TCFG.keyframe_protect_recent))
            victims.append((want, got, score))
        steps.append((jax.tree_util.tree_map(np.asarray, j_state), port))
    return steps, victims, free, tpg.optimize.pcg_solves - pcg0


def test_mission_victims_equal(mission):
    _, victims, _, _ = mission
    assert len(victims) >= 20
    for want, got, score in victims:
        two = np.argsort(score, kind="stable")[:2]
        if score[two[1]] - score[two[0]] <= 1e-5:
            assert got in set(two.tolist())
        else:
            assert got == want


def test_mission_per_step_stores_and_edges(mission):
    steps, _, _, pcg = mission
    assert pcg >= 5  # the mission's graph solves ran PCG
    for want, got in steps:
        _assert_edges_close(got.edges, want.edges)
        assert int(got.keyframes.count) == int(want.keyframes.count)
        assert int(got.keyframes.evictions) == int(want.keyframes.evictions)
        n = int(want.keyframes.count)
        dt = np.abs(got.keyframes.pose_graph.t[:n].numpy() - want.keyframes.pose_graph.t[:n])
        assert dt.max() <= 2e-3, dt.max()
    assert int(steps[-1][0].keyframes.evictions) >= 20


def test_mission_free_run_outlives_the_store(mission):
    _, _, free, _ = mission
    assert int(free.keyframes.evictions) > 0
    assert int(free.keyframes.count) == TCFG.max_keyframes
    n = int(free.edges.count)
    assert bool(free.edges.valid[:n].all()) and not bool(free.edges.valid[n:].any())
    assert torch.isfinite(free.slam_pose.t).all()
