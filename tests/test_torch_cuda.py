"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: the
kernels have no CPU mode. The file imports neither ``jax`` nor the JAX
package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

Shapes are ragged on purpose (N not a multiple of the 64-thread block, M
not a multiple of the 256-point tile). Tolerances:
- K1/K2 d²: 1e-6 abs + 1e-6 rel — kernel and plain version evaluate the
  same subtraction form in float32 on query-centred coordinates, without
  FMA contraction;
- K3 (radius moments): the hard count exactly (membership is decided on
  the same float32 d² in both), count/mean/cov within 1e-5 abs + 1e-5 rel
  (the sums are reduced in another order);
- K4 (matmul-form 1-NN): d² within 4e-7·(|q_c|² + |t_c|²) + 1e-6, the
  rounding of the form, and a differing pick only where the two picks'
  exact d² lie that close.
"""

import numpy as np
import pytest
import torch

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


@pytest.mark.cuda
@pytest.mark.parametrize("valid_len", [None, 0, 700])
def test_nn1_matches_plain(dev, valid_len):
    q, _ = _cloud(1, 1000)
    t, mask = _cloud(2, 1300, live=0.8)
    if valid_len is not None:
        mask[valid_len:] = False
    q, t, mask = q.to(dev), t.to(dev), mask.to(dev)
    vl = None if valid_len is None else torch.tensor(valid_len, dtype=torch.int32, device=dev)
    before = tnn.nn1_cuda.launches
    k = tnn.nearest_neighbors(q, t, mask, valid_len=vl)
    p = tnn.nearest_neighbors_plain(q, t, mask, vl)
    torch.cuda.synchronize()
    assert tnn.nn1_cuda.launches == before + 1
    torch.testing.assert_close(k.dist2, p.dist2, rtol=1e-6, atol=1e-6)
    fin = torch.isfinite(p.dist2)
    assert torch.equal(k.idx[fin], p.idx[fin])
    assert torch.equal(k.idx[~fin], torch.zeros_like(k.idx[~fin]))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 16])
def test_knn_matches_plain(dev, k):
    pts, mask = _cloud(3, 1100, live=0.9)
    pts, mask = pts.to(dev), mask.to(dev)
    before = tnn.knn_cuda.launches
    ki, kd = tnn.knn(pts, pts, mask, k)
    pi, pd = tnn.knn_plain(pts, pts, mask, k)
    torch.cuda.synchronize()
    assert tnn.knn_cuda.launches == before + 1
    torch.testing.assert_close(kd, pd, rtol=1e-6, atol=1e-6)
    assert torch.equal(ki, pi)
    live = mask.nonzero(as_tuple=True)[0]
    assert torch.equal(ki[live, 0], live) and bool((kd[live, 0] == 0).all())


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


@pytest.mark.cuda
@pytest.mark.parametrize("valid_len", [None, 0, 700])
def test_nn1_matmul_matches_plain(dev, valid_len):
    q, _ = _cloud(6, 1000)
    t, mask = _cloud(7, 1300, live=0.8)
    if valid_len is not None:
        mask[valid_len:] = False
    q, t, mask = q.to(dev), t.to(dev), mask.to(dev)
    vl = None if valid_len is None else torch.tensor(valid_len, dtype=torch.int32, device=dev)
    before = tnn.nn1_matmul_cuda.launches
    k = tnn.nearest_neighbors_matmul(q, t, mask, valid_len=vl)
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
