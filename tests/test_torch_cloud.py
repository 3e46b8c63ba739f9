"""Port voxel filter (``icpslam_tpu_torch.cloud.voxel``) against the JAX one.

Key order, mask and voxel count must be identical; centroids agree within
1e-5 m. Reason for the tolerance: the JAX filter takes centroids from
float32 prefix sums of voxel-relative offsets, which round at |Σ|·2⁻²⁴
per prefix; with at most 250 raw points (|Σ| < 75 at leaf 0.3) the
difference of two prefixes stays below 1e-5 m, while the port accumulates
in float64 (its own error is ~5e-7 m).
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
from icpslam_tpu_torch.cloud import pointcloud as tpc
from icpslam_tpu_torch.cloud.voxel import voxel_downsample as port_voxel
from icpslam_tpu_torch.io import synthetic as tsyn


@pytest.fixture(scope="module")
def scans():
    world = tsyn.make_room_world(0, 8000)
    gt = tsyn.make_loop_trajectory(n_poses=8, radius=3.0, laps=1.0)
    return [
        (pts, mask)
        for pts, mask in tsyn.scan_stream(world, gt, capacity=1024, max_range=12.0,
                                          n_points=250, noise=0.01)
    ]


def _both(pts, mask, leaf, cap):
    jf, jn = jax_voxel(jpc.PointCloud(jnp.asarray(pts), jnp.asarray(mask)), leaf, cap)
    tf, tn = port_voxel(tpc.PointCloud(torch.from_numpy(pts), torch.from_numpy(mask)), leaf, cap)
    return (np.asarray(jf.points), np.asarray(jf.mask), int(jn)), (
        tf.points.numpy(), tf.mask.numpy(), int(tn)
    )


@pytest.mark.parametrize("leaf,cap", [(0.3, 512), (0.2, 256), (0.3, 96)])
def test_voxel_matches_jax(scans, leaf, cap):
    for pts, mask in scans:
        (jp, jm, jn), (tp, tm, tn) = _both(pts, mask, leaf, cap)
        assert tn == jn
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-5)


def test_voxel_key_order(scans):
    # output rows follow the packed 11/11/10-bit key order: x slab first
    pts, mask = scans[0]
    (_, _, _), (tp, tm, _) = _both(pts, mask, 0.3, 512)
    live = tp[tm]
    cells = np.floor(live / 0.3).astype(np.int64)
    key = (cells[:, 0] - cells[:, 0].min()) * 2**21 + (cells[:, 1] - cells[:, 1].min()) * 2**10 + (
        cells[:, 2] - cells[:, 2].min()
    )
    assert np.all(np.diff(key) > 0)


def test_voxel_empty_and_tail_padding():
    pts = np.zeros((64, 3), np.float32)
    mask = np.zeros(64, bool)
    (jp, jm, jn), (tp, tm, tn) = _both(pts, mask, 0.2, 32)
    assert jn == tn == 0 and not tm.any() and not jm.any()
    np.testing.assert_array_equal(tp, 0.0)
