"""The port's counterparts of the JAX package's public helpers, against
JAX's on the same seeded numpy inputs (CPU).

One parametrised test: each case builds its inputs with numpy, calls the
JAX function and the port's, and compares within the case's stated
tolerance (``atol``; 0 means equal arrays):

- ``cloud/pointcloud.py``: ``from_points`` (and its error past capacity),
  ``to_numpy``, ``masked_centroid``;
- ``geometry``: ``quaternion.from_matrix`` (Shepperd's four branches, each
  chosen by some input), ``from_axis_angle``, ``from_rpy``, ``to_rpy``,
  ``se3.from_matrix``, ``se3.stack``;
- ``eval/metrics.py``: ``align_trajectories``;
- ``ops/kabsch.py``: ``weighted_rigid_align_comps``;
- ``ops/linalg3.py``: the ten matrix helpers;
- ``mapping``: ``point_map.exact_nn`` and ``backend.query_nn`` on the
  point map (distances within 1e-5: JAX's CPU search is the blocked
  matmul form, so ties may pick another index) and on one voxel map
  (equal).
"""

import torch

# one intra-op thread per test worker: the suite runs several pytest
# workers on the host's cores beside XLA's own pool
torch.set_num_threads(1)

import jax.numpy as jnp
import numpy as np
import pytest

from icpslam_tpu import config as jconfig
from icpslam_tpu.cloud import pointcloud as jpc
from icpslam_tpu.eval import metrics as jmetrics
from icpslam_tpu.geometry import quaternion as jquat
from icpslam_tpu.geometry import se3 as jse3
from icpslam_tpu.mapping import backend as jbackend
from icpslam_tpu.mapping import point_map as jpm
from icpslam_tpu.mapping import voxel_map as jvm
from icpslam_tpu.ops import kabsch as jkabsch
from icpslam_tpu.ops import linalg3 as jla
from icpslam_tpu_torch import config as tconfig
from icpslam_tpu_torch.cloud import pointcloud as tpc
from icpslam_tpu_torch.eval import metrics as tmetrics
from icpslam_tpu_torch.geometry import quaternion as tquat
from icpslam_tpu_torch.geometry import se3 as tse3
from icpslam_tpu_torch.mapping import backend as tbackend
from icpslam_tpu_torch.mapping import point_map as tpm
from icpslam_tpu_torch.mapping import voxel_map as tvm
from icpslam_tpu_torch.ops import kabsch as tkabsch
from icpslam_tpu_torch.ops import linalg3 as tla


def _rng(seed=0):
    return np.random.RandomState(seed)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _rotations(n, seed=0):
    """Random rotation matrices plus the four Shepperd branches: identity
    (w largest) and a half-turn about x, y and z (x, y, z largest)."""
    q = _rng(seed).randn(n, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    mats = np.asarray(jquat.to_matrix(jnp.asarray(q)))
    branches = np.stack([np.eye(3), np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]),
                         np.diag([-1.0, -1, 1])]).astype(np.float32)
    return np.concatenate([mats, branches])


def _spd(n, seed=0):
    a = _rng(seed).randn(n, 3, 3).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(3, dtype=np.float32)).astype(np.float32)


def _pose_pair(p_j, p_t):
    return [(p_j.t, p_t.t), (p_j.q, p_t.q)]


def case_from_points():
    pts = _rng(1).randn(37, 3).astype(np.float32)
    j, t = jpc.from_points(pts, capacity=64), tpc.from_points(pts, capacity=64, device="cpu")
    with pytest.raises(ValueError, match="exceed capacity"):
        jpc.from_points(pts, capacity=8)
    with pytest.raises(ValueError, match="exceed capacity"):
        tpc.from_points(pts, capacity=8, device="cpu")
    assert t.points.dtype == torch.float32 and t.points.shape == (64, 3)
    return [(j.points, t.points), (j.mask, t.mask)]


def case_to_numpy():
    pts = _rng(2).randn(50, 3).astype(np.float32)
    mask = _rng(3).rand(50) > 0.4
    return [(jpc.to_numpy(jpc.PointCloud(jnp.asarray(pts), jnp.asarray(mask))),
             tpc.to_numpy(tpc.PointCloud(_t(pts), _t(mask))))]


def case_masked_centroid():
    pts = _rng(4).randn(2, 40, 3).astype(np.float32) + 5.0
    mask = _rng(5).rand(2, 40) > 0.5
    mask[1] = False   # an empty cloud: zeros in both
    return [(jpc.masked_centroid(jpc.PointCloud(jnp.asarray(pts), jnp.asarray(mask))),
             tpc.masked_centroid(tpc.PointCloud(_t(pts), _t(mask))))]


def case_quat_from_matrix():
    m = _rotations(64)
    return [(jquat.from_matrix(jnp.asarray(m)), tquat.from_matrix(_t(m)))]


def case_quat_from_axis_angle():
    axis = _rng(6).randn(16, 3).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    ang = _rng(7).uniform(-np.pi, np.pi, 16).astype(np.float32)
    return [(jquat.from_axis_angle(jnp.asarray(axis), jnp.asarray(ang)),
             tquat.from_axis_angle(_t(axis), _t(ang)))]


def case_quat_from_rpy():
    r, p, y = _rng(8).uniform(-1.5, 1.5, (3, 16)).astype(np.float32)
    scalar = (jquat.from_rpy(0.1, -0.2, 0.3), tquat.from_rpy(0.1, -0.2, 0.3, device="cpu"))
    return [(jquat.from_rpy(jnp.asarray(r), jnp.asarray(p), jnp.asarray(y)),
             tquat.from_rpy(_t(r), _t(p), _t(y))), scalar]


def case_quat_to_rpy():
    q = _rng(9).randn(32, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return list(zip(jquat.to_rpy(jnp.asarray(q)), tquat.to_rpy(_t(q))))


def case_se3_from_matrix():
    m = np.zeros((68, 4, 4), np.float32)
    m[:, :3, :3] = _rotations(64, seed=10)
    m[:, :3, 3] = _rng(11).randn(68, 3)
    m[:, 3, 3] = 1.0
    return _pose_pair(jse3.from_matrix(jnp.asarray(m)), tse3.from_matrix(_t(m)))


def case_se3_stack():
    t = _rng(12).randn(5, 3).astype(np.float32)
    q = _rng(13).randn(5, 4).astype(np.float32)
    j = jse3.stack([jse3.Pose(t=jnp.asarray(a), q=jnp.asarray(b)) for a, b in zip(t, q)])
    p = tse3.stack([tse3.Pose(t=_t(a), q=_t(b)) for a, b in zip(t, q)])
    return _pose_pair(j, p)


def case_align_trajectories():
    rng = _rng(14)
    gt_t = np.cumsum(rng.randn(60, 3), 0).astype(np.float32)
    gt_q = np.tile(np.float32([1, 0, 0, 0]), (60, 1))
    T = jse3.se3_exp(jnp.asarray([0.5, -1.0, 0.2, 0.1, -0.05, 0.3], jnp.float32))
    est_t = np.asarray(jse3.transform_points(jse3.inverse(T), jnp.asarray(gt_t)))
    est_t = (est_t + 0.01 * rng.randn(60, 3)).astype(np.float32)
    j = jmetrics.align_trajectories(jse3.Pose(jnp.asarray(est_t), jnp.asarray(gt_q)),
                                    jse3.Pose(jnp.asarray(gt_t), jnp.asarray(gt_q)))
    p = tmetrics.align_trajectories(tse3.Pose(_t(est_t), _t(gt_q)), tse3.Pose(_t(gt_t), _t(gt_q)))
    return _pose_pair(j, p)


def case_weighted_rigid_align_comps():
    rng = _rng(15)
    src = rng.randn(200, 3).astype(np.float32)
    T = jse3.se3_exp(jnp.asarray([0.3, 0.1, -0.2, 0.05, 0.02, -0.1], jnp.float32))
    dst = (np.asarray(jse3.transform_points(T, jnp.asarray(src)))
           + 0.01 * rng.randn(200, 3)).astype(np.float32)
    w = (rng.rand(200) * (rng.rand(200) > 0.2)).astype(np.float32)
    j, j_ok = jkabsch.weighted_rigid_align_comps(*jnp.asarray(src.T), *jnp.asarray(dst.T),
                                                 jnp.asarray(w))
    p, p_ok = tkabsch.weighted_rigid_align_comps(*_t(src.T), *_t(dst.T), _t(w))
    # no weight: identity and not ok, in both
    _, j_none = jkabsch.weighted_rigid_align_comps(*jnp.asarray(src.T), *jnp.asarray(dst.T),
                                                   jnp.zeros(200))
    _, p_none = tkabsch.weighted_rigid_align_comps(*_t(src.T), *_t(dst.T), torch.zeros(200))
    assert bool(j_ok) and p_ok and not bool(j_none) and not p_none
    return _pose_pair(j, p)


def case_linalg3_det_inv_sym():
    a = _rng(16).randn(32, 3, 3).astype(np.float32)
    a[0] = 0.0   # singular: the clamped determinant
    return [(jla.det3(jnp.asarray(a)), tla.det3(_t(a))),
            (jla.inv3(jnp.asarray(a[1:])), tla.inv3(_t(a[1:]))),
            (jla.symmetrize(jnp.asarray(a)), tla.symmetrize(_t(a)))]


def case_linalg3_inv3_singular():
    a = np.zeros((2, 3, 3), np.float32)
    return [(jla.inv3(jnp.asarray(a)), tla.inv3(_t(a)))]


def case_linalg3_solve_psd():
    h = _rng(17).randn(8, 6, 6).astype(np.float32)
    h = (h @ np.swapaxes(h, -1, -2) + 0.5 * np.eye(6, dtype=np.float32)).astype(np.float32)
    b = _rng(18).randn(8, 6).astype(np.float32)
    return [(jla.solve_psd(jnp.asarray(h), jnp.asarray(b)), tla.solve_psd(_t(h), _t(b))),
            (jla.solve_psd(jnp.asarray(h), jnp.asarray(b), damping=0.1),
             tla.solve_psd(_t(h), _t(b), damping=0.1))]


def case_linalg3_eig():
    a = _spd(64, seed=19)
    a[0] = 2.0 * np.eye(3)   # isotropic: all eigenvalues equal, fallback vector
    return [(jla.eigvals_sym3(jnp.asarray(a)), tla.eigvals_sym3(_t(a))),
            (jla.smallest_eigenvector_sym3(jnp.asarray(a)), tla.smallest_eigenvector_sym3(_t(a)))]


def case_linalg3_packing():
    a = _spd(10, seed=20)
    p6 = np.asarray(jla.pack_sym3(jnp.asarray(a)))
    c6 = np.asarray(jla.mat_to_sym6(jnp.asarray(a)))
    return [(p6, tla.pack_sym3(_t(a))), (jla.unpack_sym3(jnp.asarray(p6)), tla.unpack_sym3(_t(p6))),
            (c6, tla.mat_to_sym6(_t(a))), (jla.sym6_to_mat(jnp.asarray(c6)), tla.sym6_to_mat(_t(c6)))]


def _map_inputs():
    rng = _rng(21)
    pts = rng.uniform(-5, 5, (700, 3)).astype(np.float32)
    queries = rng.uniform(-6, 6, (96, 3)).astype(np.float32)
    qmask = rng.rand(96) > 0.1
    return pts, queries, qmask


def case_point_map_nn():
    pts, queries, qmask = _map_inputs()
    C, size = 1024, 700
    buf = np.zeros((C, 3), np.float32)
    buf[:size] = pts
    covs = np.tile(np.float32([1, 0, 0, 1, 0, 1])[:, None], (1, C))
    jmap = jpm.PointMap(jnp.asarray(buf), jnp.asarray(covs), jnp.int32(size), jnp.int32(0))
    tmap = tpm.PointMap(_t(buf), _t(covs), torch.tensor(size, dtype=torch.int32),
                        torch.tensor(0, dtype=torch.int32))
    cfg_j, cfg_t = jconfig.tiny_config(), tconfig.tiny_config()
    j = jpm.exact_nn(jmap, jnp.asarray(queries), jnp.asarray(qmask))
    t = tpm.exact_nn(tmap, _t(queries), _t(qmask))
    jq = jbackend.query_nn(jmap, jnp.asarray(queries), jnp.asarray(qmask), cfg_j)
    tq = tbackend.query_nn(tmap, _t(queries), _t(qmask), cfg_t)
    # the same call as exact_nn_with_covs, without the covariance gather
    tc, _ = tpm.exact_nn_with_covs(tmap, _t(queries), _t(qmask))
    for a, b in zip(t, tc):
        assert torch.equal(a, b)
    # the winner lies at the reported distance
    d2 = ((t.points - _t(queries)) ** 2).sum(-1)
    assert torch.allclose(d2[t.found], t.dist2[t.found], rtol=0, atol=1e-5)
    return [(j.dist2, t.dist2), (j.found, t.found), (jq.dist2, tq.dist2), (jq.found, tq.found)]


def case_voxel_map_nn():
    pts, queries, qmask = _map_inputs()
    res = 0.5
    # one map for both: the port's insert, its arrays handed to JAX's map
    # (the inserts' voxel means sum in another order)
    tmap = tvm.insert(tvm.empty_map(1024, device="cpu"),
                      tpc.from_points(pts, capacity=1024, device="cpu"), res)
    jmap = jvm.VoxelMap(*(jnp.asarray(x.numpy()) for x in tmap))
    cfg_j = jconfig.tiny_config(map_backend="voxel", map_resolution=res)
    cfg_t = tconfig.tiny_config(map_backend="voxel", map_resolution=res)
    j = jbackend.query_nn(jmap, jnp.asarray(queries), jnp.asarray(qmask), cfg_j)
    t = tbackend.query_nn(tmap, _t(queries), _t(qmask), cfg_t)
    assert int(t.found.sum()) > 0
    return [(j.points, t.points), (j.dist2, t.dist2), (j.found, t.found)]


# case → (function, atol); atol 0: equal arrays
CASES = {
    "from_points": (case_from_points, 0.0),
    "to_numpy": (case_to_numpy, 0.0),
    "masked_centroid": (case_masked_centroid, 1e-6),
    "quaternion.from_matrix": (case_quat_from_matrix, 1e-6),
    "quaternion.from_axis_angle": (case_quat_from_axis_angle, 1e-6),
    "quaternion.from_rpy": (case_quat_from_rpy, 1e-6),
    "quaternion.to_rpy": (case_quat_to_rpy, 1e-5),
    "se3.from_matrix": (case_se3_from_matrix, 1e-6),
    "se3.stack": (case_se3_stack, 0.0),
    "align_trajectories": (case_align_trajectories, 1e-4),
    "weighted_rigid_align_comps": (case_weighted_rigid_align_comps, 1e-5),
    "linalg3.det3-inv3-symmetrize": (case_linalg3_det_inv_sym, 1e-4),
    "linalg3.inv3-singular": (case_linalg3_inv3_singular, 0.0),
    "linalg3.solve_psd": (case_linalg3_solve_psd, 1e-4),
    "linalg3.eigvals-eigenvector": (case_linalg3_eig, 1e-4),
    "linalg3.packing": (case_linalg3_packing, 0.0),
    "point_map.exact_nn-query_nn": (case_point_map_nn, 1e-5),
    "voxel_map.query_nn": (case_voxel_map_nn, 0.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_helper_matches_jax(case):
    fn, atol = CASES[case]
    pairs = fn()
    assert pairs
    for i, (j, t) in enumerate(pairs):
        j, t = _np(j), _np(t)
        assert j.shape == t.shape, (i, j.shape, t.shape)
        if atol == 0.0 or j.dtype == bool:
            np.testing.assert_array_equal(t, j, err_msg=f"{case} output {i}")
        else:
            np.testing.assert_allclose(t, j, rtol=0, atol=atol, err_msg=f"{case} output {i}")
