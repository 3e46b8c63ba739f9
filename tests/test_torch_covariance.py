"""Port GICP covariances (``icpslam_tpu_torch.ops.covariance``) against JAX.

The JAX reference runs as on the CPU: its XLA top-k neighbour selection is
exact there (``approx_max_k`` reduces to ``top_k``). Tolerances, each on
at least 99% of the live points: normals |n·n′| > 0.999, and all six
regularized covariance components within 1e-4. The rest are points whose
k-th and (k+1)-th neighbours tie within the matmul form's rounding, or
whose two smallest neighbourhood eigenvalues nearly tie so that float32
rounding of the moments turns the normal by more than 1e-4 rad.
"""

import torch

# one intra-op thread per test worker: the suite runs several pytest
# workers on the host's cores beside XLA's own pool
torch.set_num_threads(1)

import jax.numpy as jnp
import numpy as np
import pytest

from icpslam_tpu.cloud import pointcloud as jpc
from icpslam_tpu.cloud.voxel import voxel_downsample as jax_voxel
from icpslam_tpu.ops import covariance as jcov
from icpslam_tpu_torch.cloud import pointcloud as tpc
from icpslam_tpu_torch.ops import covariance as tcov
from icpslam_tpu_torch.io import synthetic as tsyn


def _normals(c6: np.ndarray) -> np.ndarray:
    """Unit normals from packed covariances I − (1−ε) n nᵀ."""
    xx, xy, xz, yy, yz, zz = c6
    m = np.stack([np.stack([xx, xy, xz], -1), np.stack([xy, yy, yz], -1),
                  np.stack([xz, yz, zz], -1)], -2)
    _, vecs = np.linalg.eigh(np.eye(3) - m.astype(np.float64))
    return vecs[..., -1]


@pytest.fixture(scope="module")
def clouds():
    world = tsyn.make_room_world(1, 10000)
    gt = tsyn.make_loop_trajectory(n_poses=4, radius=3.0)
    out = []
    for pts, mask in tsyn.scan_stream(world, gt, capacity=1024, max_range=12.0,
                                      n_points=1000, noise=0.01):
        f, _ = jax_voxel(jpc.PointCloud(jnp.asarray(pts), jnp.asarray(mask)), 0.3, 512)
        out.append((np.asarray(f.points), np.asarray(f.mask)))
    return out


@pytest.mark.parametrize("k", [10, 6])
def test_covariances_match_jax(clouds, k):
    for pts, mask in clouds:
        ref = np.asarray(jcov.gicp_covariances(
            jpc.PointCloud(jnp.asarray(pts), jnp.asarray(mask)), k=k, epsilon=1e-3
        ))
        got = tcov.gicp_covariances(
            tpc.PointCloud(torch.tensor(pts), torch.tensor(mask)), k=k, epsilon=1e-3
        ).numpy()
        assert got.shape == ref.shape == (6, pts.shape[0])
        # padding keeps the identity
        np.testing.assert_array_equal(got[:, ~mask], ref[:, ~mask])
        dots = np.abs((_normals(got[:, mask]) * _normals(ref[:, mask])).sum(-1))
        assert (dots > 0.999).mean() >= 0.99, (dots > 0.999).mean()
        close = (np.abs(got[:, mask] - ref[:, mask]) <= 1e-4).all(0)
        assert close.mean() >= 0.99, close.mean()


def test_sparse_cloud_gets_identity():
    pts = np.zeros((32, 3), np.float32)
    pts[:2] = [[0, 0, 0], [1, 0, 0]]
    mask = np.zeros(32, bool)
    mask[:2] = True
    got = tcov.gicp_covariances(tpc.PointCloud(torch.from_numpy(pts), torch.from_numpy(mask))).numpy()
    np.testing.assert_array_equal(got, np.tile(np.asarray(tcov.EYE6, np.float32)[:, None], (1, 32)))
