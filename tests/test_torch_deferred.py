"""The port's pipelined back end (``icpslam_tpu_torch/pipeline/deferred.py``)
against the JAX one (``icpslam_tpu/pipeline/deferred.py``).

A room loop (1.25 laps, 20 scans) runs through JAX's ``slam_step`` with
``defer_optimization`` on a fixed schedule: a snapshot solve is launched
after the first scan whose window has filled and folded two scans later,
again and again. The states at each launch and before each fold are
carried into the port (``utils/interop.py``), which calls the same modules:

- ``solve_snapshot`` on the launch states, window branch (no loop closure
  since the last solve; ``graph_window`` 4, so the window starts past node
  0) and full branch: poses within 1e-5 m of JAX's;
- ``fold`` on the pre-fold states with the port's solves: keyframe graph
  poses and the map-frame pose after the fold within 1e-4 m of JAX's,
  counters equal.

Both backends, each over its own package's ``slam_step``, with
``max_lag=0`` (the probe read and the solve folded on the next call,
whatever the device) at the runners' two ``check_every`` values: the
port's launches and folds come on JAX's calls, and the final graph and
map-frame poses agree within 1e-4 m. With a device that never reports a
solve done, each fold comes ``max_lag`` calls after its launch and the
launches spread out as ``max_lag`` grows.

Then, port only: the backend against the inline back end over the same
scans (``tests/test_deferred.py::test_matches_inline_quality``), the
``ValueError`` without ``defer_optimization``, and a fold across an
eviction, which must put each snapshot pose on the keyframe it belongs to
(keyframes told apart by stamp) — where JAX's fold would put it on a
neighbour.
"""

import torch

# one intra-op thread per test worker: the suite runs several pytest
# workers on the host's cores beside XLA's own pool
torch.set_num_threads(1)

import jax
import numpy as np
import pytest

from icpslam_tpu.cloud import pointcloud as jpc
from icpslam_tpu.config import IcpConfig, tiny_config
from icpslam_tpu.geometry import se3 as jse3
from icpslam_tpu.pipeline import deferred as jdef
from icpslam_tpu.pipeline import slam as jslam
from icpslam_tpu_torch import config as tconfig
from icpslam_tpu_torch.cloud import pointcloud as tpc
from icpslam_tpu_torch.eval import metrics
from icpslam_tpu_torch.geometry import se3 as tse3
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.graph import keyframes as tkf
from icpslam_tpu_torch.graph import marginalize as tmarg
from icpslam_tpu_torch.graph import pose_graph as tpg
from icpslam_tpu_torch.io import runner as trunner
from icpslam_tpu_torch.io import synthetic as tsyn
from icpslam_tpu_torch.pipeline import deferred as tdef
from icpslam_tpu_torch.pipeline import slam as tslam
from icpslam_tpu_torch.utils import interop

OVER = dict(
    voxel_leaf_size=0.3,
    map_resolution=0.3,
    icp_odometry=IcpConfig(mode="plane", max_iterations=10),
    icp_mapping=IcpConfig(mode="point", max_iterations=20),
    max_points=512,
    max_raw_points=1024,
    max_map_points=8192,
    max_keyframes=32,
    max_edges=128,
    keyframe_distance=0.3,
    keyframes_window=4,
    graph_window=4,
    loop_closure_radius=3.0,
    loop_closure_min_id_gap=3,
)
N_SCANS = 20
LAG = 2


def _tcfg(**kw):
    return tconfig.tiny_config(**{**OVER, **kw})


def _counts(np_state):
    return dict(keyframes=int(np_state.keyframes.count), edges=int(np_state.edges.count),
                lc_since_opt=int(np_state.lc_since_opt))


@pytest.fixture(scope="module")
def scans():
    world = tsyn.make_room_world(0, 12000)
    gt = tsyn.make_loop_trajectory(n_poses=N_SCANS, radius=3.0, laps=1.25)
    return list(tsyn.scan_stream(world, gt, capacity=OVER["max_raw_points"], max_range=12.0,
                                 n_points=1000, noise=0.01, seed=1)), gt


@pytest.fixture(scope="module")
def schedule(scans):
    """JAX's pipeline on the fixed schedule. Returns a list of (launch
    state, JAX solve, pre-fold state, folded state) as numpy trees."""
    cfg = tiny_config(**OVER, defer_optimization=True)
    pts_gt, gt = scans
    step = jax.jit(jslam.slam_step, static_argnums=(2,))
    solve_fn = jax.jit(jdef.solve_snapshot, static_argnums=(1,))
    fold_fn = jax.jit(jdef.fold, static_argnums=(2,))
    state = jslam.init_state(cfg, initial_pose=jse3.Pose(t=gt[0][0], q=gt[1][0]))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    events, pending = [], None
    for k, (pts, mask) in enumerate(pts_gt):
        state, _ = step(state, jpc.PointCloud(points=pts, mask=mask), cfg)
        if pending is not None and k == pending[0] + LAG:
            pre = to_np(state)
            state = fold_fn(state, pending[2], cfg)
            events.append((pending[1], to_np(pending[2]), pre, to_np(state)))
            pending = None
        elif pending is None and int(state.kf_since_opt) >= cfg.keyframes_window:
            pending = (k, to_np(state), solve_fn(state, cfg))
    return events


def test_schedule_covers_both_branches(schedule):
    lcs = [int(launch.lc_since_opt) for launch, *_ in schedule]
    assert len(schedule) >= 3
    assert min(lcs) == 0 and max(lcs) > 0, lcs
    assert any(int(launch.keyframes.count) > OVER["graph_window"] for launch, *_ in schedule)


@pytest.mark.parametrize("branch", ["window", "full"])
def test_solve_snapshot_matches_jax(schedule, branch):
    cfg = _tcfg(defer_optimization=True)
    cases = [(launch, js) for launch, js, _, _ in schedule
             if (int(launch.lc_since_opt) > 0) == (branch == "full")]
    assert cases
    for launch, js in cases:
        solve = tdef.solve_snapshot(interop.state_from_numpy(launch, device="cpu"), cfg,
                                    _counts(launch))
        n = int(launch.keyframes.count)
        np.testing.assert_allclose(solve.nodes.t.numpy()[:n], js.nodes.t[:n], rtol=0, atol=1e-5)
        np.testing.assert_allclose(solve.nodes.q.numpy()[:n], js.nodes.q[:n], rtol=0, atol=1e-5)
        np.testing.assert_allclose(solve.map_to_odom.t.numpy(), js.map_to_odom.t, rtol=0, atol=1e-5)
        assert int(solve.snapshot_count) == int(js.snapshot_count)
        assert int(solve.snapshot_lc) == int(js.snapshot_lc)


def test_fold_on_the_schedule_matches_jax(schedule):
    cfg = _tcfg(defer_optimization=True)
    for launch, _, pre, folded in schedule:
        solve = tdef.solve_snapshot(interop.state_from_numpy(launch, device="cpu"), cfg,
                                    _counts(launch))
        got = tdef.fold(interop.state_from_numpy(pre, device="cpu"), solve, cfg)
        n = int(folded.keyframes.count)
        np.testing.assert_allclose(got.keyframes.pose_graph.t.numpy()[:n],
                                   folded.keyframes.pose_graph.t[:n], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got.keyframes.pose_graph.q.numpy()[:n],
                                   folded.keyframes.pose_graph.q[:n], rtol=0, atol=1e-4)
        # the map-frame pose of the stream right after the fold
        pose = tse3.compose(got.map_to_odom, got.slam_pose).t.numpy()
        want = jse3.compose(folded.map_to_odom, folded.slam_pose).t
        np.testing.assert_allclose(pose, np.asarray(want), rtol=0, atol=1e-4)
        for name in ("kf_since_opt", "lc_since_opt", "num_optimizations"):
            assert int(getattr(got, name)) == int(getattr(folded, name)), name
        assert int(got.map.size) == int(folded.map.size)


@pytest.fixture(scope="module")
def jax_step():
    return jax.jit(jslam.slam_step, static_argnums=(2,))


@pytest.mark.parametrize("check_every", [1, OVER["keyframes_window"]],
                         ids=["every-call", "every-window"])
def test_backend_schedule_matches_jax(scans, jax_step, check_every):
    """JAX's ``DeferredBackend`` and the port's, each after its own
    package's step, with ``max_lag=0``: JAX's launch and fold calls (read
    from ``num_launched`` / ``num_folded`` after each call) are the
    port's, and after ``flush`` the poses agree within 1e-4 m."""
    pts_gt, gt = scans
    jcfg = tiny_config(**OVER, defer_optimization=True)
    tcfg = _tcfg(defer_optimization=True)
    jb = jdef.DeferredBackend(jcfg, max_lag=0, check_every=check_every)
    tb = tdef.DeferredBackend(tcfg, max_lag=0, check_every=check_every)
    js = jslam.init_state(jcfg, initial_pose=jse3.Pose(t=gt[0][0], q=gt[1][0]))
    ts = tslam.init_state(tcfg, initial_pose=Pose(torch.from_numpy(gt[0][0]),
                                                  torch.from_numpy(gt[1][0])), device="cpu")
    launched, folded = [], []
    for k, (pts, mask) in enumerate(pts_gt):
        js, _ = jax_step(js, jpc.PointCloud(points=pts, mask=mask), jcfg)
        n_launched, n_folded = jb.num_launched, jb.num_folded
        js = jb.maybe_launch_or_fold(js)
        if jb.num_launched > n_launched:
            launched.append(k)
        if jb.num_folded > n_folded:
            folded.append(k)
        ts, out = tslam.slam_step(ts, tpc.PointCloud(torch.from_numpy(pts),
                                                     torch.from_numpy(mask)), tcfg)
        ts = tb.maybe_launch_or_fold(ts, out)
    assert len(launched) >= 3, launched
    assert tb.launched_at == launched
    assert tb.folded_at == folded
    js, ts = jb.flush(js), tb.flush(ts)
    assert (tb.num_launched, tb.num_folded) == (jb.num_launched, jb.num_folded)
    assert int(ts.num_optimizations) == int(js.num_optimizations)
    n = int(js.keyframes.count)
    assert int(ts.keyframes.count) == n
    np.testing.assert_allclose(ts.keyframes.pose_graph.t.numpy()[:n],
                               np.asarray(js.keyframes.pose_graph.t)[:n], rtol=0, atol=1e-4)
    pose = tse3.compose(ts.map_to_odom, ts.slam_pose).t.numpy()
    want = jse3.compose(js.map_to_odom, js.slam_pose).t
    np.testing.assert_allclose(pose, np.asarray(want), rtol=0, atol=1e-4)


class _NeverReady(tdef.DeferredBackend):
    """A device that never reports a solve done: each fold waits out
    ``max_lag`` calls."""

    def _ready(self):
        return False


@pytest.mark.parametrize("check_every", [1, OVER["keyframes_window"]],
                         ids=["every-call", "every-window"])
def test_fold_lag_spaces_the_launches(scans, check_every):
    """The later a solve is reported done, the fewer solves a stream
    launches: each fold comes ``max_lag`` calls after its launch, and the
    calls between two launches grow with ``max_lag`` (every-call: 5, 6,
    10; every-window: 6, 9, 13 at ``max_lag`` 1, 4, 8)."""
    pts_gt, gt = scans
    cfg = _tcfg(defer_optimization=True)
    gaps = []
    for lag in (1, 4, 8):
        backend = _NeverReady(cfg, max_lag=lag, check_every=check_every)
        state = tslam.init_state(cfg, initial_pose=Pose(torch.from_numpy(gt[0][0]),
                                                        torch.from_numpy(gt[1][0])), device="cpu")
        for pts, mask in pts_gt:
            state, out = tslam.slam_step(state, tpc.PointCloud(torch.from_numpy(pts),
                                                               torch.from_numpy(mask)), cfg)
            state = backend.maybe_launch_or_fold(state, out)
        assert len(backend.launched_at) >= 2, backend.launched_at
        assert all(f - l == lag for l, f in zip(backend.launched_at, backend.folded_at))
        gaps.append(backend.launched_at[1] - backend.launched_at[0])
    assert gaps[0] < gaps[1] < gaps[2], gaps


def test_matches_inline_quality(scans):
    """Both runs through the runner's loop, the deferred one with the
    backend as its ``post_step`` hook."""
    pts_gt, gt = scans
    gt_pose = Pose(torch.from_numpy(gt[0]), torch.from_numpy(gt[1]))
    init = tse3.index(gt_pose, 0)
    stream = [(s, 0.1 * k) for k, s in enumerate(pts_gt)]

    def run(cfg, backend=None):
        post = backend.maybe_launch_or_fold if backend is not None else None
        res = trunner.run_slam(stream, cfg, init, "cpu", post_step=post)
        return res.state, float(metrics.ate(res.trajectory, gt_pose, align=False)[0])

    st_in, ate_in = run(_tcfg())
    assert int(st_in.num_optimizations) >= 2
    cfg_def = _tcfg(defer_optimization=True)
    backend = tdef.DeferredBackend(cfg_def, max_lag=3)
    std, ate_def = run(cfg_def, backend)
    std = backend.flush(std)
    assert backend.num_launched >= 2
    assert backend.num_folded == backend.num_launched
    assert int(std.num_optimizations) == backend.num_folded
    assert ate_def < max(2.5 * ate_in, 0.25), (ate_def, ate_in)
    n = int(std.keyframes.count)
    assert torch.isfinite(std.keyframes.pose_graph.t[:n]).all()


def test_backend_requires_deferred_config():
    with pytest.raises(ValueError, match="defer_optimization"):
        tdef.DeferredBackend(_tcfg())


def _full_store(K=8, seed=0):
    """A port state with a full store of K keyframes along a noisy line,
    stamped 0..K-1, a sequential chain of edges measured from the truth and
    a graph estimate that drifts from it."""
    cfg = _tcfg(max_keyframes=K, defer_optimization=True, keyframe_protect_recent=2,
                graph_incremental=False)
    rng = np.random.RandomState(seed)
    state = tslam.init_state(cfg, device="cpu")
    truth = Pose(torch.tensor(np.c_[np.arange(K) * 1.0, np.zeros((K, 2))], dtype=torch.float32),
                 torch.tensor(np.tile([1.0, 0, 0, 0], (K, 1)), dtype=torch.float32))
    drift = tse3.se3_exp(torch.tensor(np.cumsum(rng.randn(K, 6) * 0.02, 0), dtype=torch.float32))
    graph = tse3.normalize(tse3.compose(truth, drift))
    store = state.keyframes._replace(
        pose_odom=graph, pose_graph=graph, stamp=torch.arange(K, dtype=torch.float32),
        count=torch.tensor(K, dtype=torch.int32),
    )
    edges = state.edges
    info = 100.0 * torch.eye(6)
    for a in range(K - 1):
        rel = tse3.relative(tse3.index(truth, a), tse3.index(truth, a + 1))
        edges = tpg.add_edge(edges, a, a + 1, rel, info)
    state = state._replace(keyframes=store, edges=edges,
                           kf_since_opt=torch.tensor(K, dtype=torch.int32))
    return state, cfg


def _evict_and_add(state, victim):
    store, edges = tmarg.marginalize_keyframe(state.keyframes, state.edges,
                                              torch.tensor(victim, dtype=torch.int32))
    pose = tse3.index(store.pose_odom, int(store.count) - 1)
    cloud = tpc.PointCloud(torch.zeros_like(store.points[0]), torch.zeros_like(store.point_mask[0]))
    store, _ = tkf.add(store, pose, pose, cloud, torch.tensor(100.0))
    return state._replace(keyframes=store, edges=edges)


def _snapshot_poses_on_own_keyframe(state, solve):
    """Max distance between each snapshot keyframe's pose after the fold
    and its optimized pose, keyframes matched by stamp."""
    stamps = state.keyframes.stamp.numpy()
    n = int(state.keyframes.count)
    err = 0.0
    for slot in range(n):
        s = int(stamps[slot])
        if s < int(solve.snapshot_count):
            d = (state.keyframes.pose_graph.t[slot] - solve.nodes.t[s]).norm()
            err = max(err, float(d))
    return err


def test_fold_across_an_eviction_keeps_each_pose_on_its_keyframe():
    state, cfg = _full_store()
    counts = dict(keyframes=8, edges=7, lc_since_opt=0)
    solve = tdef.solve_snapshot(state, cfg, counts)
    moved = float((solve.nodes.t - state.keyframes.pose_graph.t).norm(dim=-1)[1:].max())
    assert moved > 1e-3
    later = _evict_and_add(state, 3)
    folded = tdef.fold(later, solve, cfg, evicted=[3])
    assert _snapshot_poses_on_own_keyframe(folded, solve) <= 1e-6
    # the keyframe added after the snapshot is re-based, and it is the one
    # keyframe the solve did not see
    new = tse3.compose(solve.map_to_odom, tse3.index(later.keyframes.pose_odom, 7))
    assert float((folded.keyframes.pose_graph.t[7] - new.t).norm()) <= 1e-6
    assert int(folded.kf_since_opt) == 1
    # JAX's fold writes slot i from pose i and misplaces every keyframe
    # above the victim
    jax_like = tdef.fold(later, solve, cfg)
    assert _snapshot_poses_on_own_keyframe(jax_like, solve) > 1e-2


def test_backend_folds_across_an_eviction():
    state, cfg = _full_store(seed=1)
    backend = tdef.DeferredBackend(cfg, max_lag=8)
    host = tslam.HostCounts(keyframes=8, edges=7, kf_since_opt=8, lc_since_opt=0, evicted=-1)
    out = tslam.SlamOutput(*([None] * 10), host=host)
    # the first call arms the trigger, the second launches
    assert backend.maybe_launch_or_fold(state, out) is state
    assert backend.num_launched == 0
    assert backend.maybe_launch_or_fold(state, out) is state
    assert backend.num_launched == 1
    solve = backend._pending
    later = _evict_and_add(state, 2)
    out = out._replace(host=host._replace(kf_since_opt=1, evicted=2))
    folded = backend.maybe_launch_or_fold(later, out)
    assert backend.num_folded == 1 and backend.folds_across_eviction == 1
    assert backend.launched_at == [1] and backend.folded_at == [2]
    assert _snapshot_poses_on_own_keyframe(folded, solve) <= 1e-6
