"""Port radius moments and radius GICP covariances against the JAX package.

``radius_moments_plain`` (the plain version of kernel K3) against JAX
``radius_moments_xla`` and the Pallas ``radius_moments`` in interpret
mode, hard cutoff and Gaussian taper, as ``tests/test_ops.py`` runs them;
then ``gicp_covariances_radius`` against JAX on room scans.

Membership at the radius: JAX decides d² < r² in matmul form on
centroid-centred coordinates, the port in subtraction form per query, so
a pair within ~1e-5·r² of the boundary can count in one and not in the
other. The random inputs below are checked (in float64) to hold no pair
within 1e-4·r² of r²; on the room scans the queries with such a pair are
left out of the comparison. Tolerances: count, mean and covariance within
1e-4 abs (the count is exactly equal for the hard cutoff).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icpslam_tpu.cloud import pointcloud as jpc
from icpslam_tpu.cloud.voxel import voxel_downsample as jax_voxel
from icpslam_tpu.ops import covariance as jcov
from icpslam_tpu.ops.pallas import radius_stats_kernel as rsk
from icpslam_tpu_torch.cloud import pointcloud as tpc
from icpslam_tpu_torch.io import synthetic as tsyn
from icpslam_tpu_torch.ops import covariance as tcov
from icpslam_tpu_torch.ops import radius_stats

MARGIN = 1e-4


def _boundary_rows(pts, mask, r):
    """Queries with a live target whose float64 d² lies within MARGIN·r² of r²."""
    p = pts.astype(np.float64)
    d2 = ((p[:, None] - p[None]) ** 2).sum(-1)
    return ((np.abs(d2 - r * r) < MARGIN * r * r) & mask[None, :]).any(1)


def _divisor_rows(count_jax):
    """Rows where both divide their sums by the same weight sum. JAX divides
    by max(Σw, 1), the port by Σw: they differ where 0 < Σw < 1 — with the
    taper, a masked query with only distant neighbours, or an isolated
    point whose only neighbour is itself at JAX's small nonzero
    matmul-form self-distance (the port's is exactly 0)."""
    return ~((count_jax > 0) & (count_jax < 1))


def _case(name):
    rng = np.random.RandomState({"plain": 1, "masked": 2, "far": 3}[name])
    pts = rng.uniform(-2, 2, (256, 3)).astype(np.float32)
    mask = np.ones(256, bool)
    if name == "masked":
        mask = rng.rand(256) > 0.4
        mask[250:] = False
    elif name == "far":
        pts = pts + np.array([1000.0, -1000.0, 1000.0], np.float32)
    return pts, mask


def _port(pts, mask, r, sigma):
    p, m = torch.tensor(pts), torch.tensor(mask)
    out = radius_stats.radius_moments(p, p, m, r, sigma=sigma)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("sigma", [0.0, 0.25])
@pytest.mark.parametrize("name", ["plain", "masked", "far"])
@pytest.mark.parametrize("ref", ["xla", "interpret"])
def test_radius_moments_match_jax(ref, name, sigma):
    pts, mask = _case(name)
    r = 0.5
    assert not _boundary_rows(pts, mask, r).any()
    args = (jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(mask), r)
    if ref == "xla":
        want = rsk.radius_moments_xla(*args, sigma=sigma)
    else:
        want = rsk.radius_moments(*args, sigma=sigma, bq=256, bt=128, interpret=True)
    got = _port(pts, mask, r, sigma)
    count, mean, cov = (np.asarray(w) for w in want)
    if sigma == 0.0:
        np.testing.assert_array_equal(got[0], count)
    np.testing.assert_allclose(got[0], count, rtol=0, atol=1e-4)
    rows = _divisor_rows(count)
    np.testing.assert_allclose(got[1][rows], mean[rows], rtol=0, atol=1e-4 if name != "far" else 2e-4)
    np.testing.assert_allclose(got[2][rows], cov[rows], rtol=0, atol=1e-4)
    # every live self-query has itself in radius
    assert np.all(got[0][mask] >= 1.0)


def test_radius_moments_all_masked_and_empty():
    pts, _ = _case("plain")
    none = np.zeros(256, bool)
    count, mean, cov = _port(pts, none, 0.5, 0.0)
    assert not count.any() and not mean.any() and not cov.any()
    want = rsk.radius_moments_xla(jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(none), 0.5)
    assert not np.asarray(want[0]).any() and not np.asarray(want[2]).any()


def test_radius_moments_match_float64():
    """The per-query form against float64 brute force (hard and tapered)."""
    pts, mask = _case("masked")
    r, sigma = 0.5, 0.25
    p = pts.astype(np.float64)
    for s in (0.0, sigma):
        count, mean, cov = _port(pts, mask, r, s)
        for i in (0, 17, 99, 200):
            d2 = ((p[mask] - p[i]) ** 2).sum(-1)
            w = np.where(d2 < r * r, np.exp(-d2 / (2 * s * s)) if s else 1.0, 0.0)
            sw = w.sum()
            m = (w[:, None] * p[mask]).sum(0) / sw
            c = np.einsum("n,ni,nj->ij", w, p[mask] - m, p[mask] - m) / sw
            np.testing.assert_allclose(count[i], sw, rtol=1e-6)
            np.testing.assert_allclose(mean[i], m, rtol=0, atol=1e-6)
            np.testing.assert_allclose(cov[i], c, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def room_clouds():
    world = tsyn.make_room_world(1, 10000)
    gt = tsyn.make_loop_trajectory(n_poses=3, radius=3.0)
    out = []
    for pts, mask in tsyn.scan_stream(world, gt, capacity=1024, max_range=12.0,
                                      n_points=1000, noise=0.01):
        f, _ = jax_voxel(jpc.PointCloud(jnp.asarray(pts), jnp.asarray(mask)), 0.3, 512)
        out.append((np.asarray(f.points), np.asarray(f.mask)))
    return out


def _normals(c6: np.ndarray) -> np.ndarray:
    """Unit normals from packed covariances I − (1−ε) n nᵀ."""
    xx, xy, xz, yy, yz, zz = c6
    m = np.stack([np.stack([xx, xy, xz], -1), np.stack([xy, yy, yz], -1),
                  np.stack([xz, yz, zz], -1)], -2)
    return np.linalg.eigh(np.eye(3) - m.astype(np.float64))[1][..., -1]


@pytest.mark.parametrize("sigma", [0.0, 0.375])
def test_gicp_covariances_radius_match_jax(room_clouds, sigma):
    """On the live points with no pair near the radius, the same divisor
    (``_divisor_rows``) and, tapered, a weight sum not within 1e-3 of the
    ``good`` threshold 2 (the hard count is exact): the moments
    agree within 1e-4 and the identity pattern is the same. The packed
    covariances: normals |n·n′| > 0.999 on ≥ 98% of them and all six
    components within 1e-3 on ≥ 95%. The rest are 3-4 point, nearly
    collinear neighbourhoods, where JAX's centroid-centred E[ppᵀ] − μμᵀ
    (~3e-5 m² of cancellation on a room scan) turns the normal. Padding
    keeps the identity exactly."""
    r = 0.75
    eye = np.asarray(tcov.EYE6, np.float32)[:, None]
    for pts, mask in room_clouds:
        jcloud = jpc.PointCloud(jnp.asarray(pts), jnp.asarray(mask))
        ref = np.asarray(jcov.gicp_covariances_radius(jcloud, radius=r, sigma=sigma))
        got = tcov.gicp_covariances_radius(
            tpc.PointCloud(torch.tensor(pts), torch.tensor(mask)), radius=r, sigma=sigma
        ).numpy()
        assert got.shape == ref.shape == (6, pts.shape[0])
        np.testing.assert_array_equal(got[:, ~mask], ref[:, ~mask])
        count, _, cov = (np.asarray(a) for a in rsk.radius_moments_xla(
            jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(mask), r, sigma=sigma))
        _, _, port_cov = _port(pts, mask, r, sigma)
        clear = mask & ~_boundary_rows(pts, mask, r) & _divisor_rows(count)
        if sigma > 0:
            clear &= np.abs(count - 2.0) > 1e-3
        assert clear.sum() >= 0.9 * mask.sum()
        np.testing.assert_allclose(port_cov[clear], cov[clear], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(
            (got[:, clear] == eye).all(0), (ref[:, clear] == eye).all(0)
        )
        dots = np.abs((_normals(got[:, clear]) * _normals(ref[:, clear])).sum(-1))
        assert (dots > 0.999).mean() >= 0.98, (dots > 0.999).mean()
        close = (np.abs(got[:, clear] - ref[:, clear]) <= 1e-3).all(0)
        assert close.mean() >= 0.95, close.mean()


def test_sparse_points_identity():
    """Isolated points (< 3 in radius) get identity, as in JAX."""
    pts = np.zeros((4, 3), np.float32)
    pts[:3] = [[0, 0, 0], [10, 0, 0], [20, 0, 0]]
    mask = np.array([True, True, True, False])
    got = tcov.gicp_covariances_radius(
        tpc.PointCloud(torch.tensor(pts), torch.tensor(mask)), radius=0.5
    ).numpy()
    ref = np.asarray(jcov.gicp_covariances_radius(
        jpc.PointCloud(jnp.asarray(pts), jnp.asarray(mask)), radius=0.5))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.tile(np.asarray(tcov.EYE6, np.float32)[:, None], (1, 4)))
