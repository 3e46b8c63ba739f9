"""The port's ``slam_step`` against the JAX one on a room-loop mission.

Twelve scans of a loop that closes (1.25 laps), under a small config.
(a) Per step from one shared state: before each scan the JAX state is
    carried into the port (``utils/interop.py``) and both packages take
    one step. Flags must be identical; the pose agrees within 1e-3 m and
    1e-3 rad, the map size within 0.5%.
(b) Free run: the port runs on its own state; the pose stays within 5 mm
    of the JAX one on every scan and the flags are identical.

The mission covers loop closures and graph optimizations. Its seed gives
loop-closure registrations that converge: a registration that does not
(30 iterations sliding along a weakly constrained direction) amplifies
the float32 differences between the exact NN search and JAX's CPU
matmul-form search into centimetres, in either package's own reruns.
"""

import torch

# one intra-op thread per test worker: the suite runs several pytest
# workers on the host's cores beside XLA's own pool
torch.set_num_threads(1)

import jax
import numpy as np
import pytest

from icpslam_tpu.config import IcpConfig, tiny_config
from icpslam_tpu.geometry import se3 as jse3
from icpslam_tpu.pipeline import slam as jslam
from icpslam_tpu_torch.cloud import pointcloud as tpc
from icpslam_tpu_torch.geometry import se3 as tse3
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.io import synthetic as tsyn
from icpslam_tpu_torch.pipeline import slam as tslam
from icpslam_tpu_torch.utils import interop
from icpslam_tpu.cloud import pointcloud as jpc

CFG = tiny_config(
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
    loop_closure_radius=3.0,
    loop_closure_min_id_gap=3,
)
N_SCANS = 12
FLAGS = {"accepted": 7, "refined": 11, "new_keyframe": 12, "loop_closure": 13,
         "optimized": 14, "num_keyframes": 16}


def _angle(qa, qb):
    d = np.abs(np.sum(qa.astype(np.float64) * qb.astype(np.float64), -1))
    return 2.0 * np.arccos(np.clip(d, 0.0, 1.0))


@pytest.fixture(scope="module")
def mission():
    world = tsyn.make_room_world(0, 12000)
    gt_t, gt_q = tsyn.make_loop_trajectory(n_poses=N_SCANS, radius=3.0, laps=1.25)
    scans = list(tsyn.scan_stream(world, (gt_t, gt_q), capacity=CFG.max_raw_points,
                                  max_range=12.0, n_points=1000, noise=0.01, seed=1))
    step = jax.jit(jslam.slam_step, static_argnums=(2,))
    j_state = jslam.init_state(CFG, initial_pose=jse3.Pose(t=gt_t[0], q=gt_q[0]))
    free = tslam.init_state(CFG, initial_pose=Pose(torch.tensor(gt_t[0]), torch.tensor(gt_q[0])),
                           device="cpu")
    rec = {"jax": [], "step": [], "free": []}
    states = []
    for pts, mask in scans:
        shared_np = jax.tree_util.tree_map(np.asarray, j_state)
        states.append(shared_np)
        shared = interop.state_from_numpy(shared_np, device="cpu")
        port_scan = tpc.PointCloud(torch.tensor(pts), torch.tensor(mask))
        j_state, jo = step(j_state, jpc.PointCloud(points=pts, mask=mask), CFG)
        _, so = tslam.slam_step(shared, port_scan, CFG)
        free, fo = tslam.slam_step(free, port_scan, CFG)
        rec["jax"].append(np.asarray(jo.packed))
        rec["step"].append(so.packed.numpy())
        rec["free"].append(fo.packed.numpy())
    return {k: np.stack(v) for k, v in rec.items()}, states


def test_mission_covers_loop_closure_and_optimization(mission):
    rec, _ = mission
    assert rec["jax"][:, FLAGS["loop_closure"]].sum() >= 1
    assert rec["jax"][:, FLAGS["optimized"]].sum() >= 1


@pytest.mark.parametrize("run", ["step", "free"])
def test_flags_identical(mission, run):
    rec, _ = mission
    for name, col in FLAGS.items():
        np.testing.assert_array_equal(rec[run][:, col], rec["jax"][:, col], err_msg=name)


def test_per_step_pose(mission):
    rec, _ = mission
    dt = np.linalg.norm(rec["step"][:, :3] - rec["jax"][:, :3], axis=-1)
    assert dt.max() <= 1e-3, dt
    assert _angle(rec["step"][:, 3:7], rec["jax"][:, 3:7]).max() <= 1e-3


def test_per_step_map_size(mission):
    rec, _ = mission
    j, s = rec["jax"][:, 15], rec["step"][:, 15]
    assert np.all(np.abs(s - j) <= 0.005 * j), (s, j)


def test_free_run_pose(mission):
    rec, _ = mission
    dt = np.linalg.norm(rec["free"][:, :3] - rec["jax"][:, :3], axis=-1)
    assert dt.max() <= 5e-3, dt


def test_state_round_trip(mission):
    _, states = mission
    tree = states[-1]
    back = interop.state_to_numpy(interop.state_from_numpy(tree, device="cpu"))
    flat_a = jax.tree_util.tree_leaves(tree)
    flat_b = jax.tree_util.tree_leaves(back)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert int(tree.keyframes.count) > 0 and int(tree.edges.count) > 0


@pytest.mark.parametrize("mapping", ["point", "plane"])
def test_uncapped_map_query_gives_the_capped_refinement(mission, monkeypatch, mapping):
    """JAX caps K1 in the map query at the larger of the two gates that
    consume it (``prune_beyond``, JAX ``mapping/scan_to_map.py:154``): a
    map point beyond it may come back as not found. The port's K1 is exact
    everywhere. On mid-mission states, with 16 returns moved far from the
    map, JAX's ``refine_and_grow`` with its capped kernel run in
    interpret mode and the port's uncapped one give
    the same found set after each gate (registration: d² ≤ the
    correspondence distance²; the insert's dedup: d² < resolution²), the
    same success and refined pose, and the same grown map."""
    import dataclasses

    from icpslam_tpu.geometry.se3 import Pose as JPose
    from icpslam_tpu.mapping import point_map as jpm
    from icpslam_tpu.mapping import scan_to_map as jstm
    from icpslam_tpu.ops import nn as jnn
    from icpslam_tpu.ops.pallas.nn_kernel import nearest_neighbors_pallas3
    from icpslam_tpu_torch.mapping import point_map as tpm
    from icpslam_tpu_torch.mapping import scan_to_map as tstm
    from icpslam_tpu_torch.pipeline import odometry as todo

    real = jnn.nearest_neighbors
    caps = []

    def capped(query, target, target_mask, *args, valid_len=None, prune_beyond=None, **kw):
        if prune_beyond is None:
            return real(query, target, target_mask, *args, valid_len=valid_len, **kw)
        caps.append(prune_beyond)
        # 16-query blocks: a block whose queries are all far from a target
        # tile skips it at the cap
        return nearest_neighbors_pallas3(query, target, target_mask, valid_len=valid_len,
                                         bq=16, bt=256, interpret=True, prune_beyond=prune_beyond)

    monkeypatch.setattr(jnn, "nearest_neighbors", capped)
    cfg = CFG if mapping == "point" else CFG.replace(
        icp_mapping=dataclasses.replace(CFG.icp_mapping, mode="plane"))
    icfg = cfg.icp_mapping
    gate, res2 = icfg.max_correspondence_distance ** 2, cfg.map_resolution ** 2
    refine = jax.jit(lambda m, s, p: jstm.refine_and_grow(m, s, p, cfg))
    query = jax.jit(lambda m, q, k: jpm.exact_nn_with_covs(
        m, q, k, prune_beyond=float(max(icfg.max_correspondence_distance, cfg.map_resolution) ** 2)))
    _, states = mission
    world = tsyn.make_room_world(0, 12000)
    gt_t, gt_q = tsyn.make_loop_trajectory(n_poses=N_SCANS, radius=3.0, laps=1.25)
    scans = list(tsyn.scan_stream(world, (gt_t, gt_q), capacity=CFG.max_raw_points,
                                  max_range=12.0, n_points=1000, noise=0.01, seed=1))
    checked = beyond = 0
    for k in (3, 6, 9):
        shared = interop.state_from_numpy(states[k], device="cpu")
        if int(shared.map.size) == 0:
            continue
        _, oout = todo.odometry_step(shared.odom, tpc.PointCloud(*map(torch.tensor, scans[k])),
                                     cfg, True, False)
        raw = tse3.normalize(tse3.compose(shared.slam_pose, oout.transform))
        # its last 16 returns (one query block) moved 12 m overhead:
        # farther from every map point than the cap, so JAX's kernel drops
        # their matches
        points, mask = oout.filtered.points.clone(), oout.filtered.mask.clone()
        points[-16:] = torch.tensor([0.0, 0.0, 12.0]) + 0.3 * torch.arange(16.0)[:, None]
        mask[-16:] = True
        scan = tpc.PointCloud(points, mask)
        jmap = jpm.PointMap(*states[k].map)
        jscan = jpc.PointCloud(points=scan.points.numpy(), mask=scan.mask.numpy())
        jraw = JPose(t=raw.t.numpy(), q=raw.q.numpy())
        # the query at the odometry pose: the found sets after the gates
        in_map = tse3.transform_points(raw, scan.points)
        mine, _ = tpm.exact_nn_with_covs(shared.map, in_map, scan.mask)
        ref, _ = query(jmap, in_map.numpy(), scan.mask.numpy())
        d2, jd2 = mine.dist2.numpy(), np.asarray(ref.dist2)
        found, jfound = mine.found.numpy(), np.asarray(ref.found)
        np.testing.assert_array_equal(found & (d2 <= gate), jfound & (jd2 <= gate))
        np.testing.assert_array_equal(found & (d2 < res2), jfound & (jd2 < res2))
        beyond += int((found & ~jfound).sum())
        # the whole refinement
        r = tstm.refine_and_grow(shared.map, scan, raw, cfg, map_empty=False)
        jr = refine(jmap, jscan, jraw)
        assert bool(r.success) == bool(jr.success)
        np.testing.assert_allclose(r.refined_pose.t.numpy(), np.asarray(jr.refined_pose.t),
                                   rtol=0, atol=1e-4)
        q, jq = r.refined_pose.q.numpy(), np.asarray(jr.refined_pose.q)
        assert min(np.abs(q - jq).max(), np.abs(q + jq).max()) <= 1e-5, (q, jq)
        assert int(r.map.size) == int(jr.map.size)
        checked += 1
    assert checked >= 2 and caps, (checked, caps)
    assert beyond > 0  # the cap did drop matches that the exact search finds
