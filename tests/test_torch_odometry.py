"""The port's odometry front end as an entry point of its own, against the
JAX package's (``icpslam_tpu/pipeline/odometry.py``) on the CPU.

- ``odometry_step(state, scan, config)`` at JAX's contract (no host flags
  passed in: the step reads them), free-running beside JAX's jitted step
  on the room world, in the cases of ``tests/test_odometry.py``: GICP
  (plane-to-plane), point-to-point, bootstrap and skip
  (``num_clouds_skip=1``) and a rejected scan. The flags (processed,
  accepted) are equal on every scan; the pose is within the case's
  tolerance of JAX's on every scan (``POSE_ATOL``: m, and quaternion
  components);
- ``run_scans`` over a stacked chunk against one-by-one driving: every
  output and the final state bit for bit, with one flag read per chunk
  instead of one per scan;
- ``drain_accumulator``: the relative motion since the start (as JAX's
  test holds it, within 1e-4 m) and JAX's drained accumulator, then
  identity after a second drain.
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
from icpslam_tpu.pipeline import odometry as jodo
from icpslam_tpu_torch import config as tconfig
from icpslam_tpu_torch.cloud import pointcloud as tpc
from icpslam_tpu_torch.geometry import se3 as tse3
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.io import synthetic as tsyn
from icpslam_tpu_torch.pipeline import odometry as todo
from icpslam_tpu_torch.utils.sync import to_host
from icpslam_tpu_torch.utils.tree import leaves

# the free-running pose against JAX's (m, and quaternion components):
# float32 sums in another order and JAX's blocked-matmul NN on the CPU
# against the exact search. Registrations that converge agree within
# ~1e-5; the point-mode
# case (JAX's test config, 15 iterations) ends most registrations at the
# iteration cap, still sliding, which amplifies those differences to ~2 mm
# in either package (5e-3 is tests/test_torch_slam.py's free-run bound)
POSE_ATOL = {"gicp": 1e-4, "point": 5e-3, "bootstrap-and-skip": 1e-4, "rejection": 1e-4}
N_SCANS = 8

BASE = dict(voxel_leaf_size=0.3, max_points=512, max_raw_points=2048)
CASES = {
    "gicp": dict(icp_odometry=IcpConfig(mode="plane", max_iterations=15)),
    "point": dict(icp_odometry=IcpConfig(mode="point", max_iterations=15)),
    "bootstrap-and-skip": dict(icp_odometry=IcpConfig(mode="point"), num_clouds_skip=1),
    "rejection": dict(icp_odometry=IcpConfig(mode="point")),
}


@pytest.fixture(scope="module")
def jax_step():
    return jax.jit(jodo.odometry_step, static_argnums=(2,))


def _room_scans(seed=0, n_poses=30, n=N_SCANS):
    world = tsyn.make_room_world(seed, 12000)
    t, q = tsyn.make_loop_trajectory(n_poses=n_poses, radius=5.0)
    scans = list(tsyn.scan_stream(world, (t, q), capacity=BASE["max_raw_points"],
                                  max_range=12.0, n_points=1500, noise=0.01, seed=seed))
    return scans[:n], (t[:n], q[:n])


def _case_scans(case):
    scans, gt = _room_scans()
    if case == "rejection":
        # the third scan moved 1 km away: no overlap, the gate rejects it
        pts, mask = scans[2]
        scans[2] = (np.where(mask[:, None], pts + 1000.0, 0.0).astype(np.float32), mask)
    return scans, gt


def _qdiff(qa, qb):
    """Largest component difference of two unit quaternions, sign aligned
    (about half the angle between them; ``arccos`` of their dot product
    cannot resolve float32 quaternions below ~7e-4 rad)."""
    sign = np.sign(np.sum(qa * qb)) or 1.0
    return float(np.abs(qa - sign * qb).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_odometry_step_matches_jax(jax_step, case):
    jcfg = tiny_config(**BASE, **CASES[case])
    tcfg = tconfig.tiny_config(**BASE, **CASES[case])
    scans, (gt_t, gt_q) = _case_scans(case)
    js = jodo.init_state(jcfg, initial_pose=jse3.Pose(t=gt_t[0], q=gt_q[0]))
    ts = todo.init_state(tcfg, initial_pose=Pose(torch.from_numpy(gt_t[0]),
                                                 torch.from_numpy(gt_q[0])), device="cpu")
    flags = {"jax": [], "port": []}
    for k, (pts, mask) in enumerate(scans):
        js, jo = jax_step(js, jpc.PointCloud(points=pts, mask=mask), jcfg)
        reads = to_host.count
        ts, to = todo.odometry_step(ts, tpc.PointCloud(torch.from_numpy(pts),
                                                       torch.from_numpy(mask)), tcfg)
        assert to_host.count > reads   # the step read its flags itself
        flags["jax"].append((bool(jo.processed), bool(jo.accepted)))
        flags["port"].append((bool(to.processed), bool(to.accepted)))
        dt = np.linalg.norm(to.pose.t.numpy() - np.asarray(jo.pose.t))
        dq = _qdiff(to.pose.q.numpy(), np.asarray(jo.pose.q))
        assert dt <= POSE_ATOL[case] and dq <= POSE_ATOL[case], (case, k, dt, dq)
        assert int(to.num_voxels) == int(jo.num_voxels)
    assert flags["port"] == flags["jax"], flags
    processed = [p for p, _ in flags["port"]]
    accepted = [a for _, a in flags["port"]]
    assert processed[0] is False   # the bootstrap scan
    if case == "bootstrap-and-skip":
        assert processed == [False, False, True, False, True, False, True, False]
    elif case == "rejection":
        assert processed[2] and not accepted[2]
        assert all(accepted[k] for k in range(1, N_SCANS) if k != 2)
    else:
        assert all(accepted[1:])
    assert int(ts.scan_count) == int(js.scan_count) == N_SCANS
    assert int(ts.skip_count) == int(js.skip_count)


def _stacked(scans):
    pts = torch.from_numpy(np.stack([p for p, _ in scans]))
    mask = torch.from_numpy(np.stack([m for _, m in scans]))
    return tpc.PointCloud(pts, mask)


@pytest.mark.parametrize("case", ["gicp", "bootstrap-and-skip"])
def test_run_scans_equals_one_by_one(case):
    cfg = tconfig.tiny_config(**BASE, **CASES[case])
    scans, (gt_t, gt_q) = _room_scans()
    init = Pose(torch.from_numpy(gt_t[0]), torch.from_numpy(gt_q[0]))
    one = todo.init_state(cfg, initial_pose=init, device="cpu")
    outs = []
    reads = to_host.count
    for pts, mask in scans:
        one, out = todo.odometry_step(one, tpc.PointCloud(torch.from_numpy(pts),
                                                          torch.from_numpy(mask)), cfg)
        outs.append(out)
    reads_one = to_host.count - reads
    state = todo.init_state(cfg, initial_pose=init, device="cpu")
    reads = to_host.count
    # two chunks: the second starts from the first's state (flags read again)
    state, first = todo.run_scans(state, _stacked(scans[:5]), cfg)
    state, second = todo.run_scans(state, _stacked(scans[5:]), cfg)
    reads_chunk = to_host.count - reads
    assert reads_one - reads_chunk == N_SCANS - 2
    for k, out in enumerate(outs):
        chunk, i = (first, k) if k < 5 else (second, k - 5)
        for a, b in zip(leaves(out), leaves(chunk)):
            assert torch.equal(a, b[i]), k
    for a, b in zip(leaves(one), leaves(state)):
        assert torch.equal(a, b)
    assert first.pose.t.shape == (5, 3) and first.filtered.points.shape == (5, 512, 3)


def test_drain_accumulator(jax_step):
    jcfg = tiny_config(**BASE, icp_odometry=IcpConfig(mode="point"))
    tcfg = tconfig.tiny_config(**BASE, icp_odometry=IcpConfig(mode="point"))
    world = tsyn.make_room_world(2, 8000)
    gt_t, gt_q = tsyn.make_loop_trajectory(n_poses=5, radius=5.0)
    scans = list(tsyn.scan_stream(world, (gt_t, gt_q), capacity=2048, n_points=800, seed=2))
    init = Pose(torch.from_numpy(gt_t[0]), torch.from_numpy(gt_q[0]))
    js = jodo.init_state(jcfg, initial_pose=jse3.Pose(t=gt_t[0], q=gt_q[0]))
    ts = todo.init_state(tcfg, initial_pose=init, device="cpu")
    for pts, mask in scans:
        js, _ = jax_step(js, jpc.PointCloud(points=pts, mask=mask), jcfg)
        ts, _ = todo.odometry_step(ts, tpc.PointCloud(torch.from_numpy(pts),
                                                      torch.from_numpy(mask)), tcfg)
    j_accum, js = jodo.drain_accumulator(js)
    accum, ts = todo.drain_accumulator(ts)
    expect = tse3.relative(init, ts.pose)
    np.testing.assert_allclose(accum.t.numpy(), expect.t.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(accum.t.numpy(), np.asarray(j_accum.t), rtol=0, atol=1e-4)
    accum2, ts = todo.drain_accumulator(ts)
    np.testing.assert_allclose(accum2.t.numpy(), np.zeros(3), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(accum2.q.numpy(), np.float32([1, 0, 0, 0]))
    assert torch.equal(ts.accum.t, torch.zeros(3))


def test_odometry_entry_points_default_to_the_card():
    """Without a named device the odometry state and a padded cloud go to
    the CUDA card; here, without one, they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    cfg = tconfig.tiny_config(**BASE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        todo.init_state(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpc.from_points(np.zeros((4, 3), np.float32))
