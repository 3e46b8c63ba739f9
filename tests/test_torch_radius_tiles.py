"""K3's tile skip rule on the CPU: ``radius_stats.swept_tiles`` and
``swept_pairs_plain`` against brute force, and against JAX.

K3 (``csrc/radius_moments.cu``) sweeps a tile of targets for a warp of 4
consecutive queries only where some query of the warp lies within r of the
tile's bounding box, by the box distance rounded as the kernel rounds it.
``swept_tiles`` computes that rule in float32 on any device; the card runs
the kernel against it (``chip_smoke.py`` phase 6, ``tests/test_torch_cuda.py``).
Here the rule itself is held to the moments it must keep:

- no pair with d² < r² (the plain version's float32 d²) lies in a tile
  that its query's warp skips;
- the plain moments summed over the swept tiles only are bit for bit the
  plain moments over all targets (skipped targets carry weight 0);
- on the room scans, those moments match JAX ``radius_moments_xla`` on
  the rows away from the radius, where the two decide membership in
  different forms: the hard count exactly, mean and covariance within
  1e-4 abs as ``tests/test_torch_radius.py`` holds them, the tapered
  weight sum within 1e-3 (JAX weighs by exp(−d²/2σ²) of its matmul-form
  d², ~1e-5 m² off on a 10 m scan; 1/2σ² = 8 turns that into ~1e-4 per
  neighbour).

Inputs: voxel-sorted room scans from ``io/synthetic.py`` under
``tiny_config()`` (r = its covariance radius, 0.5 m); a 0.25 m grid cloud
with a target at d² == r² exactly, one at a tile's box edge just inside r,
and duplicates in different tiles; ragged N and M; a query 700 m from
every target. The rule takes any tile size: besides K3's 256, tiles of
128 and of 32, which give these small scans enough tiles to skip.
"""

import torch

# one intra-op thread per test worker: the suite runs several pytest
# workers on the host's cores beside XLA's own pool
torch.set_num_threads(1)

import jax.numpy as jnp
import numpy as np
import pytest

from icpslam_tpu.ops.pallas import radius_stats_kernel as rsk
from icpslam_tpu_torch.cloud.pointcloud import PointCloud
from icpslam_tpu_torch.cloud.voxel import voxel_downsample
from icpslam_tpu_torch.config import tiny_config
from icpslam_tpu_torch.io import synthetic as tsyn
from icpslam_tpu_torch.ops import radius_stats as rs
from icpslam_tpu_torch.ops.nn import _sqdist

W = rs.QUERIES_PER_WARP
MARGIN = 1e-4


def _room_scans():
    """Three voxel-filtered room scans under tiny_config() (key-sorted)."""
    cfg = tiny_config()
    world = tsyn.make_room_world(1, 10000)
    gt = tsyn.make_loop_trajectory(n_poses=3, radius=3.0)
    out = []
    for pts, mask in tsyn.scan_stream(world, gt, capacity=cfg.max_raw_points, n_points=1000):
        f, _ = voxel_downsample(PointCloud(torch.from_numpy(pts), torch.from_numpy(mask)),
                                cfg.voxel_leaf_size, cfg.max_points)
        out.append((f.points.clone(), f.mask.clone()))
    return out


def _grid_cloud(r):
    """A voxel-sorted cloud on a 0.25 m grid (every coordinate and every
    difference below exact in float32), with duplicates of low-index rows
    over rows of the last tiles. Queries = the cloud with row ``p_row``
    replaced by P, 50 m above it. B (row 5, tile 0) lies exactly r below P,
    so d² == r² (not in radius) and tile 0's box lies exactly r from P; A
    (row live − 2, the last tile) lies r − r/256 below P, at the top of its
    tile's box, so the box distance equals d² < r²."""
    rng = np.random.RandomState(3)
    pts = (rng.rand(1500, 3) * [40, 40, 4] - [20, 20, 2]).astype(np.float32)
    f, _ = voxel_downsample(PointCloud(torch.from_numpy(pts), torch.ones(1500, dtype=torch.bool)),
                            0.4, 1400)
    t, mask = torch.round(f.points * 4) / 4, f.mask.clone()
    live = int(mask.sum())
    assert bool(mask[:live].all()) and live > 600
    t[live - 7 - 9 * torch.arange(30)] = t[3 + 11 * torch.arange(30)]
    px, py = float(t[300, 0]), float(t[300, 1])
    pz = float(t[:live, 2].max()) + 50.0
    t[5] = torch.tensor([px, py, pz - r])
    t[live - 2] = torch.tensor([px, py, pz - (r - r / 256)])
    p_row = 401
    q = t.clone()
    q[p_row] = torch.tensor([px, py, pz])
    return q, t, mask, p_row


def _case(name, r):
    if name.startswith("room scan"):
        pts, mask = _room_scans()[int(name[-1])]
        return pts, pts, mask
    if name == "grid: radius boundary, duplicates":
        q, t, mask, _ = _grid_cloud(r)
        return q, t, mask
    if name == "ragged 997x1203":
        q, t, mask, _ = _grid_cloud(r)
        return q[:997].contiguous(), t[:1203].contiguous(), mask[:1203]
    if name == "one query 700 m away":
        q, t, mask, _ = _grid_cloud(r)
        q[210] = torch.tensor([500.0, -400.0, 300.0])
        return q, t, mask
    raise ValueError(name)


CASES = ["room scan 0", "room scan 2", "grid: radius boundary, duplicates",
         "ragged 997x1203", "one query 700 m away"]
R = tiny_config().icp_odometry.covariance_radius


def _in_radius(q, t, mask, r):
    r2, _ = rs._params(r, 0.0)
    return mask[None, :] & (_sqdist(t[None, :, :] - q[:, None, :]) < r2)


def _moments_over_swept(q, t, mask, r, sigma, tile):
    """The plain moments of each warp's queries over the targets of its
    swept tiles only."""
    swept, _ = rs.swept_tiles(q, t, mask, r, tile)
    tile_of = torch.arange(t.shape[0]) // tile
    parts = []
    for w in range(swept.shape[0]):
        keep = mask & swept[w][tile_of]
        parts.append(rs.radius_moments_plain(q[w * W:(w + 1) * W], t, keep, r, sigma))
    return tuple(torch.cat(x) for x in zip(*parts))


@pytest.mark.parametrize("tile", [32, 128])
@pytest.mark.parametrize("name", CASES)
def test_no_pair_in_radius_is_skipped(name, tile):
    q, t, mask = _case(name, R)
    swept, live = rs.swept_tiles(q, t, mask, R, tile)
    n, m = q.shape[0], t.shape[0]
    assert swept.shape == (-(-n // W), -(-m // tile))
    assert torch.equal(live, torch.cat([mask, mask.new_zeros(-m % tile)]).view(-1, tile).sum(1))
    inside = _in_radius(q, t, mask, R)
    i, j = inside.nonzero(as_tuple=True)
    assert i.numel() > n // 2
    assert bool(swept[i // W, j // tile].all())
    if tile == 32:
        assert not bool(swept.all()), "the rule skips nothing here"
    counted = torch.clamp(n - W * torch.arange(swept.shape[0]), max=W)
    want = int(sum(int(counted[w]) * int(live[swept[w]].sum()) for w in range(swept.shape[0])))
    assert rs.swept_pairs_plain(q, t, mask, R, tile) == want


@pytest.mark.parametrize("sigma", [0.0, 0.25])
@pytest.mark.parametrize("name", CASES)
def test_swept_tiles_keep_the_plain_moments(name, sigma):
    q, t, mask = _case(name, R)
    want = rs.radius_moments_plain(q, t, mask, R, sigma)
    got = _moments_over_swept(q, t, mask, R, sigma, 32)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_radius_boundary_and_box_edge():
    """B at d² == r² is out of radius but its tile, whose box lies exactly
    at r², is swept ('<='); A at the box edge just inside r is counted."""
    q, t, mask, p_row = _grid_cloud(R)
    r2, _ = rs._params(R, 0.0)
    live = int(mask.sum())
    for tile in (32, 128, 256):
        swept, _ = rs.swept_tiles(q, t, mask, R, tile)
        last = (live - 2) // tile
        lo, hi = t[:tile].amin(0), t[:tile].amax(0)
        gap0 = torch.clamp(torch.maximum(lo - q[p_row], q[p_row] - hi), min=0.0)
        tl = t[last * tile:(last + 1) * tile][mask[last * tile:(last + 1) * tile]]
        gap1 = torch.clamp(torch.maximum(tl.amin(0) - q[p_row], q[p_row] - tl.amax(0)), min=0.0)
        assert float(_sqdist(gap0)) == r2 == float(_sqdist(t[5] - q[p_row]))
        assert float(_sqdist(gap1)) == float(_sqdist(t[live - 2] - q[p_row])) < r2
        assert bool(swept[p_row // W, 0]) and bool(swept[p_row // W, last])
    count, mean, _ = rs.radius_moments_plain(q, t, mask, R)
    assert float(count[p_row]) == 1.0
    assert torch.equal(mean[p_row], t[live - 2])
    dup = live - 7
    assert float(count[dup]) >= 2.0


def test_far_query_sweeps_nothing_of_its_own():
    q, t, mask = _case("one query 700 m away", R)
    far = q[210:211]
    swept, _ = rs.swept_tiles(far, t, mask, R, 128)
    assert not bool(swept.any())
    assert rs.swept_pairs_plain(far, t, mask, R, 128) == 0
    assert float(rs.radius_moments_plain(far, t, mask, R)[0][0]) == 0.0


@pytest.mark.parametrize("sigma", [0.0, 0.25])
def test_swept_moments_match_jax_on_room_scans(sigma):
    """The moments over swept tiles against JAX ``radius_moments_xla``, as
    ``tests/test_torch_radius.py`` holds the plain version to it."""
    for pts, mask in _room_scans():
        count, mean, cov = (x.numpy() for x in _moments_over_swept(pts, pts, mask, R, sigma, 32))
        p, m = pts.numpy(), mask.numpy()
        want = [np.asarray(a) for a in rsk.radius_moments_xla(
            jnp.asarray(p), jnp.asarray(p), jnp.asarray(m), R, sigma=sigma)]
        d2 = ((p[:, None].astype(np.float64) - p[None].astype(np.float64)) ** 2).sum(-1)
        clear = ~((np.abs(d2 - R * R) < MARGIN * R * R) & m[None, :]).any(1)
        clear &= ~((want[0] > 0) & (want[0] < 1))
        assert clear.sum() >= 0.9 * p.shape[0]
        if sigma == 0.0:
            np.testing.assert_array_equal(count[clear], want[0][clear])
        np.testing.assert_allclose(count[clear], want[0][clear], rtol=0, atol=1e-3)
        np.testing.assert_allclose(mean[clear], want[1][clear], rtol=0, atol=1e-4)
        np.testing.assert_allclose(cov[clear], want[2][clear], rtol=0, atol=1e-4)
