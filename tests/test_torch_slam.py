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

import jax
import numpy as np
import pytest
import torch

from icpslam_tpu.config import IcpConfig, tiny_config
from icpslam_tpu.geometry import se3 as jse3
from icpslam_tpu.pipeline import slam as jslam
from icpslam_tpu_torch.cloud import pointcloud as tpc
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
