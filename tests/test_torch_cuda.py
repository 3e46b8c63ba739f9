"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: the
kernels have no CPU mode. The file imports neither ``jax`` nor the JAX
package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

Shapes are ragged on purpose (N not a multiple of a warp's queries, M
not a multiple of the 256-point tile). K1, K2 and K3 also meet the cases
that their tile skip must get right: voxel-sorted slab clouds (where the
skip fires), exact duplicates in different tiles, a query far from every
target, and a target exactly at the AABB-bound distance (K3: at d² == r²,
and at a tile's box edge just inside r); K3's pair counter must equal
``radius_stats.swept_pairs_plain``. Tolerances:
- K1/K2: d² equal bit for bit and indices equal — kernel and plain
  version evaluate the same subtraction form in float32 on query-centred
  coordinates, without FMA contraction, and order by (d², index);
- K3 (radius moments): the hard count exactly on every row (membership
  is decided on the same float32 d² in both), count/mean/cov within 1e-5
  abs + 1e-5 rel (the sums are reduced in another order);
- K4 (matmul-form 1-NN): d² within 4e-7·(|q_c|² + |t_c|²) + 1e-6, the
  rounding of the form, and a differing pick only where the two picks'
  exact d² lie that close;
- the captured graph solves (``graph/captured.py``) against the eager
  solve on the card, per bucket (direct at 64, 128 and 256 nodes, PCG at
  512) and for the window solve: poses within 1e-4 m, final cost within
  1e-4 relative (the node sums take no atomics on the card, so the two
  agree to the bit; the tolerance allows the rounding of another order);
- the endpoint sums of the solves on the card (products with the
  incidence matrices) against ``index_add_`` on the CPU: within 1e-4 on
  sums of ~64 terms of size ~1, and equal to the bit from run to run;
- ``coupled_deskew_icp`` on one physics scan pair at ``kitti_config()``
  width, through K1 against the same call with K1's plain version on the
  card: iterations and correspondence counts equal, pose and twist within
  1e-6 (K1 equals its plain version bit for bit; the rest is the same
  device arithmetic);
- voxel coordinates on the card equal the CPU's on points at and next to
  the voxel faces (the division by the resolution is correctly rounded
  on both);
- the voxel map's insert and ``approx_nn`` 2 km from the origin on the
  card against the CPU: keys, sizes and hits equal, points within
  2.5e-4 m (two float32 ulps at 2 km: the voxel filter's prefix sums run
  in another order on the card); each query's pick at a d² within 1e-3
  of the CPU's (a near-tie may pick another of the candidates: the d²
  sums round in another order);
- the scan prefetch's pinned, side-stream uploads equal their arrays.
"""

import torch

# one intra-op thread per test worker: the suite runs several pytest
# workers on the host's cores beside XLA's own pool
torch.set_num_threads(1)

import functools

import numpy as np
import pytest

from icpslam_tpu_torch.cloud.pointcloud import PointCloud
from icpslam_tpu_torch.cloud.voxel import voxel_downsample
from icpslam_tpu_torch.geometry import se3
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.graph import captured
from icpslam_tpu_torch.graph import pose_graph as tpg
from icpslam_tpu_torch.ops import nn as tnn
from icpslam_tpu_torch.ops import radius_stats as trs


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _cloud(seed, n, live=1.0):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(n, 3) * 5).astype(np.float32)
    mask = rng.rand(n) < live
    return torch.from_numpy(pts), torch.from_numpy(mask)


def _slab_cloud(seed, n_raw, cap, grid=False):
    """A voxel-filtered cloud (0.4 m leaves, sorted by the x-major voxel
    key, so consecutive rows are thin x-slabs) in a 40 × 40 × 4 m box, its
    live rows a prefix of ``cap``; ``grid`` rounds it to 0.25 m, which with
    a power-of-two row count keeps every centred coordinate exact."""
    rng = np.random.RandomState(seed)
    pts = (rng.rand(n_raw, 3) * [40, 40, 4] - [20, 20, 2]).astype(np.float32)
    filt, _ = voxel_downsample(
        PointCloud(torch.from_numpy(pts), torch.ones(n_raw, dtype=torch.bool)), 0.4, cap
    )
    p = torch.round(filt.points * 4) / 4 if grid else filt.points
    return p.clone(), filt.mask.clone()


def _with_duplicates(pts, mask):
    """Copies of low-index live rows over live rows near the end."""
    live = int(mask.sum())
    pts[live - 3 - 5 * torch.arange(20)] = pts[3 + 29 * torch.arange(20)]
    return pts


def _aabb_bound(pts, mask, p_row):
    """Queries = ``pts`` with row ``p_row`` replaced by P, 50 m above the
    cloud, whose only neighbours are B (row 5, tile 0) and A (row live − 2,
    the last tile), both exactly 0.5 m away; tile 0's box lies exactly 0.5 m
    from P and the search reaches A's tile first, so only an inclusive
    skip test gives B."""
    live = int(mask.sum())
    x0 = float(pts[:256, 0].max()) + 1.0
    y0 = float(pts[0, 1])
    z0 = float(pts[:live, 2].max()) + 50.0
    pts[5] = torch.tensor([x0 - 0.5, y0, z0])
    pts[live - 2] = torch.tensor([x0 + 0.5, y0, z0])
    q = pts.clone()
    q[p_row] = torch.tensor([x0, y0, z0])
    return q, pts


def _nn1_case(case):
    """(q, t, mask, valid_len) on the CPU for a test_nn1_matches_plain case."""
    vl = None
    if case in ("random", "valid_len 0", "valid_len 700"):
        q, _ = _cloud(1, 1000)
        t, mask = _cloud(2, 1300, live=0.8)
        if case != "random":
            vl = int(case.split()[1])
            mask[vl:] = False
    elif case == "slab clouds":
        q, _ = _slab_cloud(8, 1200, 1300)
        t, mask = _slab_cloud(9, 1100, 1250)
    elif case == "duplicates across tiles":
        t, mask = _slab_cloud(10, 1200, 1300, grid=True)
        t = _with_duplicates(t, mask)
        q = t.clone()
    elif case == "one query far away":
        q, _ = _slab_cloud(8, 1200, 1300)
        t, mask = _slab_cloud(9, 1100, 1250)
        q[500] = torch.tensor([500.0, -400.0, 300.0])
    elif case == "target at the AABB bound":
        t, mask = _slab_cloud(11, 950, 1024, grid=True)
        q, t = _aabb_bound(t, mask, 600)
    elif case == "all masked":
        q, _ = _cloud(1, 1000)
        t, mask = _cloud(2, 1300)
        mask[:] = False
    return q, t, mask, vl


NN1_CASES = ["random", "valid_len 0", "valid_len 700", "slab clouds", "duplicates across tiles",
             "one query far away", "target at the AABB bound", "all masked"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", NN1_CASES)
def test_nn1_matches_plain(dev, case):
    q, t, mask, vl = _nn1_case(case)
    q, t, mask = q.to(dev), t.to(dev), mask.to(dev)
    vl = None if vl is None else torch.tensor(vl, dtype=torch.int32, device=dev)
    before = tnn.nn1_cuda.launches
    k = tnn.nearest_neighbors(q, t, mask, valid_len=vl)
    p = tnn.nearest_neighbors_plain(q, t, mask, vl)
    torch.cuda.synchronize()
    assert tnn.nn1_cuda.launches == before + 1
    assert torch.equal(k.dist2.view(torch.int32), p.dist2.view(torch.int32))
    assert torch.equal(k.idx, p.idx)
    fin = torch.isfinite(p.dist2)
    assert torch.equal(k.idx[~fin], torch.zeros_like(k.idx[~fin]))
    if case == "target at the AABB bound":
        assert int(p.idx[600]) == 5 and float(p.dist2[600]) == 0.25
    if case == "duplicates across tiles":
        live = int(mask.sum())
        assert int(k.idx[live - 3]) <= 3 and float(k.dist2[live - 3]) == 0.0


def _knn_case(case):
    """(q, t, mask) on the CPU for a test_knn_matches_plain case."""
    if case == "random":
        t, mask = _cloud(3, 1100, live=0.9)
        return t, t, mask
    if case == "slab self":
        t, mask = _slab_cloud(12, 1200, 1300)
        return t, t, mask
    if case == "duplicates in the k-list":
        t, mask = _slab_cloud(10, 1200, 1300, grid=True)
        t = _with_duplicates(t, mask)
        return t, t, mask
    if case == "one query far away":
        t, mask = _slab_cloud(12, 1200, 1300)
        q, _ = _slab_cloud(13, 1000, 1100)
        q[70] = torch.tensor([500.0, -400.0, 300.0])
        return q, t, mask
    if case == "5 live":
        t, mask = _slab_cloud(12, 1200, 1300)
        mask[5:] = False
        return t, t, mask
    if case == "target at the AABB bound":
        t, mask = _slab_cloud(11, 950, 1024, grid=True)
        q, t = _aabb_bound(t, mask, 600)
        return q, t, mask
    raise ValueError(case)


@pytest.mark.cuda
@pytest.mark.parametrize("case, k", [
    ("random", 1), ("random", 10), ("random", 16), ("slab self", 10),
    ("duplicates in the k-list", 10), ("one query far away", 10), ("5 live", 10),
    ("target at the AABB bound", 1),
])
def test_knn_matches_plain(dev, case, k):
    q, t, mask = _knn_case(case)
    q, t, mask = q.to(dev), t.to(dev), mask.to(dev)
    before = tnn.knn_cuda.launches
    ki, kd = tnn.knn(q, t, mask, k)
    pi, pd = tnn.knn_plain(q, t, mask, k)
    torch.cuda.synchronize()
    assert tnn.knn_cuda.launches == before + 1
    assert torch.equal(kd.view(torch.int32), pd.view(torch.int32))
    assert torch.equal(ki, pi)
    if case in ("random", "slab self"):
        live = mask.nonzero(as_tuple=True)[0]
        assert torch.equal(ki[live, 0], live) and bool((kd[live, 0] == 0).all())
    if case == "duplicates in the k-list":
        assert bool(((kd[:, :-1] == kd[:, 1:]) & torch.isfinite(kd[:, 1:])).any())
    if case == "5 live":
        assert bool(torch.isinf(kd[:, 5:]).all()) and bool((ki[:, 5:] == 0).all())
    if case == "target at the AABB bound":
        assert int(pi[600, 0]) == 5


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [0.0, 0.6])
@pytest.mark.parametrize("offset", [0.0, 1000.0])
def test_radius_moments_match_plain(dev, sigma, offset):
    q, _ = _cloud(4, 1000)
    t, mask = _cloud(5, 1300, live=0.7)
    q, t = q * 0.3 + offset, t * 0.3 + offset
    q, t, mask = q.to(dev), t.to(dev), mask.to(dev)
    before = trs.radius_moments_cuda.launches
    k = trs.radius_moments(q, t, mask, 1.2, sigma=sigma)
    p = trs.radius_moments_plain(q, t, mask, 1.2, sigma=sigma)
    torch.cuda.synchronize()
    assert trs.radius_moments_cuda.launches == before + 1
    if sigma == 0.0:
        assert torch.equal(k[0], p[0])
    assert bool((p[0] > 0).any())
    for a, b in zip(k, p):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _radius_boundary(t, mask, p_row, r):
    """Queries = ``t`` with row ``p_row`` replaced by P, 50 m above the
    cloud; B (row 5, tile 0) exactly r below P (d² == r², out of radius,
    and tile 0's box exactly r from P), A (row live − 2, the last tile)
    r − r/256 below P at the top of its tile's box (in radius)."""
    live = int(mask.sum())
    px, py = float(t[300, 0]), float(t[300, 1])
    pz = float(t[:live, 2].max()) + 50.0
    t[5] = torch.tensor([px, py, pz - r])
    t[live - 2] = torch.tensor([px, py, pz - (r - r / 256)])
    q = t.clone()
    q[p_row] = torch.tensor([px, py, pz])
    return q, t


K3_RADIUS = 1.0


def _k3_case(case):
    """(q, t, mask) on the CPU for a test_radius_moments_skip_matches_plain case."""
    if case == "slab self":
        t, mask = _slab_cloud(14, 1200, 1300)
        return t, t, mask
    if case == "slab grid, duplicates, radius boundary":
        t, mask = _slab_cloud(10, 1200, 1300, grid=True)
        t = _with_duplicates(t, mask)
        q, t = _radius_boundary(t, mask, 601, K3_RADIUS)
        return q, t, mask
    if case == "one query far away":
        t, mask = _slab_cloud(14, 1200, 1300)
        q = t.clone()
        q[70] = torch.tensor([500.0, -400.0, 300.0])
        return q, t, mask
    if case == "ragged":
        t, mask = _slab_cloud(14, 1200, 1300)
        q, _ = _slab_cloud(15, 1000, 1100)
        return q[:997].clone(), t[:1203].clone(), mask[:1203].clone()
    raise ValueError(case)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [0.0, 0.5])
@pytest.mark.parametrize("case", ["slab self", "slab grid, duplicates, radius boundary",
                                  "one query far away", "ragged"])
def test_radius_moments_skip_matches_plain(dev, case, sigma):
    q, t, mask = _k3_case(case)
    q, t, mask = q.to(dev), t.to(dev), mask.to(dev)
    pairs = torch.zeros(1, dtype=torch.int64, device=dev)
    k = trs.radius_moments_cuda(q, t, mask, K3_RADIUS, sigma, pairs=pairs)
    p = trs.radius_moments_plain(q, t, mask, K3_RADIUS, sigma)
    torch.cuda.synchronize()
    if sigma == 0.0:
        assert torch.equal(k[0], p[0])
    for a, b in zip(k, p):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    want = trs.swept_pairs_plain(q, t, mask, K3_RADIUS)
    assert int(pairs) == want
    assert want < q.shape[0] * int(mask.sum()), "the skip never fired"
    if case.startswith("slab grid") and sigma == 0.0:
        assert float(p[0][601]) == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "valid_len 0", "valid_len 700", "valid_len 1037",
                                  "ragged", "slab map"])
def test_nn1_matmul_matches_plain(dev, case):
    q, _ = _cloud(6, 1000)
    t, mask = _cloud(7, 1300, live=0.8)
    valid_len = None
    if case.startswith("valid_len"):
        valid_len = int(case.split()[1])
        mask[valid_len:] = False
    elif case == "ragged":
        q, t, mask = q[:997].clone(), t[:1203].clone(), mask[:1203].clone()
    elif case == "slab map":
        q, _ = _slab_cloud(8, 1200, 1300)
        t, mask = _slab_cloud(9, 1100, 1250)
        t = torch.cat([t, torch.zeros(3000, 3)])
        mask = torch.cat([mask, torch.zeros(3000, dtype=torch.bool)])
        valid_len = int(mask.sum()) + 5
    q, t, mask = q.to(dev), t.to(dev), mask.to(dev)
    vl = None if valid_len is None else torch.tensor(valid_len, dtype=torch.int32, device=dev)
    before = tnn.nn1_matmul_cuda.launches
    k = tnn.nn1_matmul_cuda(q, t, mask, vl)
    p = tnn.nearest_neighbors_matmul_plain(q, t, mask, vl)
    torch.cuda.synchronize()
    assert tnn.nn1_matmul_cuda.launches == before + 1
    fin = torch.isfinite(p.dist2)
    assert torch.equal(fin, torch.isfinite(k.dist2))
    assert torch.equal(k.idx[~fin], torch.zeros_like(k.idx[~fin]))
    center = q.mean(0)
    qc, tc = q - center, t - center
    qc2, tc2 = (qc * qc).sum(-1), (tc * tc).sum(-1)
    tol = 4e-7 * (qc2 + torch.maximum(tc2[k.idx], tc2[p.idx])) + 1e-6
    assert bool(((k.dist2 - p.dist2).abs() <= tol)[fin].all())
    exact_k = ((tc[k.idx] - qc) ** 2).sum(-1)
    exact_p = ((tc[p.idx] - qc) ** 2).sum(-1)
    differ = (k.idx != p.idx) & fin
    assert bool(((exact_k - exact_p).abs() <= tol)[differ].all())
    assert bool(mask[k.idx][fin].all())
    if valid_len is not None:
        assert bool((k.idx < max(valid_len, 1)).all())


@pytest.mark.cuda
def test_nn1_matmul_ties_go_to_the_lowest_index(dev):
    """Exact duplicates in different tiles and lanes: the matmul form of
    a duplicate rounds alike, so the lowest index must win."""
    t, mask = _slab_cloud(10, 1200, 1300, grid=True)
    t = _with_duplicates(t, mask)
    live = int(mask.sum())
    same = (t[:, None, :] == t[None, :, :]).all(-1) & mask[None, :]
    first = same.int().argmax(1)          # the lowest live index at the same point
    dst = live - 3 - 5 * torch.arange(20)
    assert bool((first[dst] < dst).all())
    k = tnn.nearest_neighbors_matmul(t.to(dev), t.to(dev), mask.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(k.idx.cpu()[mask], first[mask])


@pytest.mark.cuda
def test_wrappers_raise_on_bad_input(dev):
    q = torch.zeros((8, 3), device=dev)
    m = torch.ones(8, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        tnn.nn1_cuda(q[:, :2], q, m)
    with pytest.raises(ValueError):
        tnn.nn1_cuda(q.T.contiguous().T, q, m)
    with pytest.raises(ValueError):
        tnn.knn_cuda(q, q.cpu(), m, 4)
    with pytest.raises(ValueError):
        trs.radius_moments_cuda(q.T.contiguous().T, q, m, 1.0)
    with pytest.raises(ValueError):
        tnn.nn1_matmul_cuda(q, q, m.cpu())


def _loop_graph(n, n_edges, dev, K=512, E=2048, seed=0):
    """n live nodes of a 512-node store on three noisy laps: the chain and
    loop edges a lap or two apart, measured with noise; the guess drifts."""
    rng = np.random.RandomState(seed + n)
    theta = np.linspace(0, 6 * np.pi, n, endpoint=False)
    t = np.zeros((K, 3))
    t[:n] = np.c_[20 * np.cos(theta), 20 * np.sin(theta), 0.5 * np.sin(3 * theta)]
    q = np.tile([1.0, 0, 0, 0], (K, 1))
    q[:n, 0], q[:n, 3] = np.cos(theta / 2 + np.pi / 4), np.sin(theta / 2 + np.pi / 4)
    truth = Pose(torch.tensor(t, dtype=torch.float32), torch.tensor(q, dtype=torch.float32))
    pairs = [(k, k + 1) for k in range(n - 1)]
    lap = max(n // 3, 2)
    while len(pairs) < n_edges:
        a = int(rng.randint(0, n - lap))
        pairs.append((a, min(n - 1, a + lap * int(rng.randint(1, 3)) + int(rng.randint(-3, 4)))))
    pairs = [(a, b) for a, b in pairs if a != b]
    ii = torch.tensor([a for a, _ in pairs])
    jj = torch.tensor([b for _, b in pairs])
    m = len(pairs)
    rel = se3.compose(se3.relative(se3.index(truth, ii), se3.index(truth, jj)),
                      se3.se3_exp(torch.tensor(rng.randn(m, 6) * 0.01, dtype=torch.float32)))
    edges = tpg.empty_edges(E)
    edges = edges._replace(
        i=edges.i.index_copy(0, torch.arange(m), ii.int()),
        j=edges.j.index_copy(0, torch.arange(m), jj.int()),
        rel_t=edges.rel_t.index_copy(0, torch.arange(m), rel.t),
        rel_q=edges.rel_q.index_copy(0, torch.arange(m), rel.q),
        info=edges.info * 100.0, valid=torch.arange(E) < m,
        count=torch.tensor(m, dtype=torch.int32),
    )
    d = np.zeros((K, 6))
    d[1:n] = np.cumsum(rng.randn(n - 1, 6) * 0.01, axis=0)
    nodes = se3.normalize(se3.compose(truth, se3.se3_exp(torch.tensor(d, dtype=torch.float32))))
    to = lambda x: x.to(dev)  # noqa: E731
    return (Pose(to(nodes.t), to(nodes.q)), tpg.EdgeSet(*(to(x) for x in edges)),
            torch.arange(K, device=dev) < n, m)


def _same_solve(a, b):
    (pa, sa), (pb, sb) = a, b
    assert float((pa.t - pb.t).norm(dim=-1).max()) <= 1e-4
    assert float((pa.q - pb.q).abs().max()) <= 1e-4
    assert abs(float(sa.final_cost) - float(sb.final_cost)) <= 1e-4 * abs(float(sb.final_cost))


@pytest.mark.cuda
@pytest.mark.parametrize("n,solver", [(50, "direct"), (100, "direct"), (200, "direct"), (400, "pcg")])
def test_captured_full_solve_equals_eager(dev, n, solver):
    nodes, edges, mask, m = _loop_graph(n, int(n * 1.5), dev)
    bucket = tpg.bucket_size(n, m, 512, 2048, 64)
    assert tpg.resolve_linear_solver("auto", bucket) == solver
    kw = dict(iterations=3, mode="lm")
    solves = captured.CapturedSolves(dev)
    pcg0 = tpg.optimize.pcg_solves
    got = solves.full(nodes, edges, mask, bucket, solver, **kw)
    again = solves.full(nodes, edges, mask, bucket, solver, **kw)
    assert len(solves.graphs) == 1
    assert tpg.optimize.pcg_solves - pcg0 == (2 if solver == "pcg" else 0)
    want = tpg.solve_bucket(nodes, edges, mask, bucket, solver, **kw)
    torch.cuda.synchronize()
    _same_solve(got, want)
    _same_solve(again, want)
    assert float(got[1].final_cost) < float(got[1].initial_cost)


@pytest.mark.cuda
def test_captured_window_solve_equals_eager(dev):
    nodes, edges, mask, _ = _loop_graph(300, 450, dev)
    count = torch.tensor(300, dtype=torch.int32, device=dev)
    kw = dict(iterations=3, mode="lm")
    solves = captured.CapturedSolves(dev)
    calls = tpg.optimize_window.calls
    got = solves.window(nodes, edges, mask, count, 64, **kw)
    assert tpg.optimize_window.calls == calls + 1
    want = tpg.optimize_window(nodes, edges, mask, count, 64, **kw)
    torch.cuda.synchronize()
    _same_solve(got, want)
    moved = (got[0].t - nodes.t).norm(dim=-1) > 1e-6
    assert moved[236:300].all() and not moved[:236].any()


@pytest.mark.cuda
def test_captured_refuses_schur_and_other_devices(dev):
    nodes, edges, mask, m = _loop_graph(50, 60, dev)
    solves = captured.CapturedSolves(dev)
    with pytest.raises(ValueError, match="schur"):
        solves.full(nodes, edges, mask, 64, "schur")
    with pytest.raises(ValueError, match="on cpu"):
        solves.full(Pose(nodes.t.cpu(), nodes.q.cpu()), edges, mask, 64, "direct")


@pytest.mark.cuda
def test_endpoint_sums_are_deterministic_and_match_index_add(dev):
    rng = np.random.RandomState(3)
    ei = torch.tensor(rng.randint(0, 64, 2048))
    ej = torch.tensor(rng.randint(0, 64, 2048))
    a = torch.tensor(rng.randn(2048, 6, 6), dtype=torch.float32)
    b = torch.tensor(rng.randn(2048, 6, 6), dtype=torch.float32)
    want = tpg._EndpointSum(ei, ej, 64, torch.float32)(a, b)
    at = tpg._EndpointSum(ei.to(dev), ej.to(dev), 64, torch.float32)
    got = at(a.to(dev), b.to(dev))
    assert torch.equal(got, at(a.to(dev), b.to(dev)))
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["direct", "pcg"])
def test_captured_dist_solve_equals_eager(dev, solver):
    from icpslam_tpu_torch.parallel import dist_graph
    from icpslam_tpu_torch.parallel import mesh as mesh_lib

    nodes, edges, mask, m = _loop_graph(100, 150, dev)
    mesh = mesh_lib.make_mesh(8, device=dev)
    kw = dict(iterations=3, mode="lm")
    solves = captured.CapturedSolves(dev)
    replays, calls = dist_graph.optimize.replays, dist_graph.optimize.calls
    got = solves.full(nodes, edges, mask, 128, solver, mesh=mesh, **kw)
    assert (dist_graph.optimize.replays - replays, dist_graph.optimize.calls - calls) == (1, 0)
    want = tpg.solve_bucket(nodes, edges, mask, 128, solver,
                            optimize_fn=functools.partial(dist_graph.optimize, mesh=mesh), **kw)
    torch.cuda.synchronize()
    _same_solve(got, want)
    _same_solve(got, tpg.solve_bucket(nodes, edges, mask, 128, solver, **kw))
    # on a mesh with a process group the dist solve runs eager, not captured
    grouped = mesh_lib.Mesh(size=8, group=object(), world=1, rank=0, device=mesh.device)
    with pytest.raises(ValueError, match="process group"):
        solves.full(nodes, edges, mask, 128, solver, mesh=grouped, **kw)


@pytest.mark.cuda
def test_batched_endpoint_sums_match_one_set_at_a_time(dev):
    rng = np.random.RandomState(4)
    ei = torch.tensor(rng.randint(0, 64, (8, 256)), device=dev)
    ej = torch.tensor(rng.randint(0, 64, (8, 256)), device=dev)
    a = torch.tensor(rng.randn(8, 256, 6), dtype=torch.float32, device=dev)
    b = torch.tensor(rng.randn(8, 256, 6), dtype=torch.float32, device=dev)
    got = tpg._EndpointSum(ei, ej, 64, torch.float32)(a, b)
    for s in range(8):
        want = tpg._EndpointSum(ei[s], ej[s], 64, torch.float32)(a[s], b[s])
        np.testing.assert_allclose(got[s].cpu().numpy(), want.cpu().numpy(), rtol=0, atol=1e-5)


def _physics_pair(dev):
    """Two consecutive physics scans of the proxy, voxel-filtered at
    ``kitti_config()`` width (131,072 raw, 8,192 filtered), with their
    k-NN covariances, on ``dev``."""
    from icpslam_tpu_torch.config import kitti_config
    from icpslam_tpu_torch.io import runner, synthetic
    from icpslam_tpu_torch.ops import covariance

    cfg = kitti_config()
    world = synthetic.make_urban_world(seed=0)
    gt = synthetic.make_urban_drive(n_poses=108)
    traj = (gt[0][104:107], gt[1][104:107])
    out = []
    for (p, m), _ in list(synthetic.velodyne_stream(
            world, traj, capacity=cfg.max_raw_points, **runner.proxy_physics()))[:2]:
        raw = PointCloud(torch.from_numpy(p).to(dev), torch.from_numpy(m).to(dev))
        f, _ = voxel_downsample(raw, cfg.voxel_leaf_size, cfg.max_points)
        out.append((f, covariance.gicp_covariances(f, k=cfg.icp_odometry.covariance_knn)))
    return cfg, out


@pytest.mark.cuda
def test_coupled_deskew_icp_through_k1_equals_plain(dev, monkeypatch):
    from icpslam_tpu_torch.cloud import deskew
    from icpslam_tpu_torch.ops import skew_icp

    cfg, ((f0, c0), (f1, c1)) = _physics_pair(dev)
    kw = dict(source_u=deskew.sweep_fraction(f1.points), source_covs=c1, target_covs=c0,
              target_valid_len=f0.mask.sum(dtype=torch.int32), free_source_twist=True,
              source_twist_prior_weight=cfg.deskew_prior_weight, want_hessian=True)
    args = (f1, f0, deskew.sweep_fraction(f0.points), cfg.icp_odometry)
    before = tnn.nn1_cuda.launches
    k = skew_icp.coupled_deskew_icp(*args, **kw)
    assert tnn.nn1_cuda.launches - before == int(k.iterations) > 0
    monkeypatch.setattr(skew_icp.nn_ops, "nearest_neighbors",
                        lambda q, t, m, valid_len=None, prune_beyond=None:
                        tnn.nearest_neighbors_plain(q, t, m, valid_len))
    p = skew_icp.coupled_deskew_icp(*args, **kw)
    assert tnn.nn1_cuda.launches - before == int(k.iterations)
    assert int(k.iterations) == int(p.iterations)
    assert int(k.num_correspondences) == int(p.num_correspondences) > 1000
    assert bool(k.converged)
    for a, b in ((k.pose.t, p.pose.t), (k.pose.q, p.pose.q), (k.skew_twist, p.skew_twist)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("resolution", [0.4, 0.6, 0.3])
def test_voxel_coords_on_the_card_equal_cpu(dev, resolution):
    from icpslam_tpu_torch.cloud.voxel import voxel_coords

    k = torch.arange(-2**14, 2**14, dtype=torch.float32) * resolution  # the faces
    faces = torch.cat([k, torch.nextafter(k, k + 1), torch.nextafter(k, k - 1)])
    pts = faces[torch.randperm(faces.numel(), generator=torch.Generator().manual_seed(0))]
    pts = pts[: pts.numel() // 3 * 3].reshape(-1, 3).contiguous()
    mask = torch.ones(pts.shape[0], dtype=torch.bool)
    want = voxel_coords(pts, resolution, mask)
    got = voxel_coords(pts.to(dev), resolution, mask.to(dev)).cpu()
    assert torch.equal(got, want), int((got != want).any(-1).sum())


@pytest.mark.cuda
def test_voxel_map_on_the_card_equals_cpu(dev):
    from icpslam_tpu_torch.mapping import voxel_map as vm

    rng = np.random.RandomState(5)
    far = np.array([2000.0, -1500.0, 3.0], np.float32)
    devs = (torch.device("cpu"), dev)
    maps = [vm.empty_map(20000, device=d) for d in devs]
    for k in range(4):
        pts = (rng.uniform(-30, 30, (9000, 3)) * [1, 1, 0.1] + far + 1.5 * k).astype(np.float32)
        for i, d in enumerate(devs):
            cloud = PointCloud(torch.from_numpy(pts).to(d), torch.ones(9000, dtype=torch.bool, device=d))
            maps[i] = vm.insert(maps[i], cloud, 0.4)
    cpu, card = maps
    size = int(cpu.size)
    assert int(card.size) == size > 0 and int(card.overflow) == int(cpu.overflow)
    assert torch.equal(card.keys.cpu(), cpu.keys)
    diff = (card.points.cpu() - cpu.points).abs().max()
    assert float(diff) <= 2.5e-4, float(diff)
    q = (rng.uniform(-35, 35, (8192, 3)) * [1, 1, 0.1] + far).astype(np.float32)
    mask = torch.from_numpy(rng.uniform(size=8192) > 0.05)
    a = vm.approx_nn(cpu, torch.from_numpy(q), mask, 0.4)
    b = vm.approx_nn(card, torch.from_numpy(q).to(dev), mask.to(dev), 0.4)
    assert torch.equal(b.found.cpu(), a.found) and bool(a.found.any())
    f = a.found
    d_card = ((b.points.cpu()[f].double() - torch.from_numpy(q)[f].double()) ** 2).sum(-1)
    gap = (d_card - a.dist2[f].double()).abs().max()
    assert float(gap) <= 1e-3, float(gap)
    assert torch.isinf(b.dist2.cpu()[~f]).all()


@pytest.mark.cuda
def test_prefetch_uploads_on_a_side_stream_equal_the_arrays(dev):
    """``io/prefetch.py`` on the card: 12 scans prepared two ahead on the
    worker, each copied into one of 3 pinned slots (so every slot is
    reused) and uploaded on the side stream, then read on the main stream
    behind the upload's event: every tensor equals its array."""
    from icpslam_tpu_torch.io import prefetch

    up = prefetch.Uploader(dev, slots=3)
    rng = np.random.RandomState(0)
    arrays = [(rng.randn(65536, 3).astype(np.float32), rng.rand(65536) < 0.7) for _ in range(12)]
    got = []
    for tensors, event in prefetch.prefetch(arrays, up.upload, depth=2):
        assert event is not None and tensors[0].device.type == "cuda"
        pts, mask = up.ready(tensors, event)
        total = torch.where(mask[:, None], pts, 0.0).sum(0)
        got.append((pts.cpu(), mask.cpu(), total.cpu()))
    for (p, m), (gp, gm, total) in zip(arrays, got):
        np.testing.assert_array_equal(gp.numpy(), p)
        np.testing.assert_array_equal(gm.numpy(), m)
        np.testing.assert_allclose(total.numpy(), np.where(m[:, None], p, 0).sum(0), atol=1e-2)
