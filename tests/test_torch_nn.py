"""Port NN search (``icpslam_tpu_torch.ops.nn``) against the JAX package.

K1: the port's ``nearest_neighbors`` (plain version on the CPU) against
``nearest_neighbors_pallas3`` in interpret mode and against the JAX XLA
(matmul-form) path. K2: the port's ``knn`` against ``knn_pallas`` in
interpret mode and ``nn.knn(approx=False)``. K4: the port's
``nearest_neighbors_matmul`` against ``nearest_neighbors_pallas`` (v1) in
interpret mode. Inputs come from numpy seeds.

Tolerances:
- d² against v3: 1e-6 abs + 1e-6 rel — both evaluate the same
  subtraction form in float32 on query-centred coordinates;
- d² against the matmul forms: 1e-4 abs, for their |q|² − 2q·t + |t|²
  cancellation;
- K4 against v1: both round the matmul form, whose error scales with the
  operands, so d² agrees within tol = 4e-7·(|q_c|² + |t_c|²) + 1e-6 (q_c,
  t_c centred on the query centroid), and where the picks differ, their
  exact d² lie within 2·tol of each other;
- indices: equal wherever the second-best d² exceeds the best by more than
  2⁻¹⁵ relative (v3 selects on d² quantized to 2⁻¹⁶ relative at bt=128,
  ``nn_kernel.py:398-400``; the matmul forms round at a similar scale).
"""

import torch

# one intra-op thread per test worker: the suite runs several pytest
# workers on the host's cores beside XLA's own pool
torch.set_num_threads(1)

import jax.numpy as jnp
import numpy as np
import pytest

from icpslam_tpu.ops import nn as jnn
from icpslam_tpu.ops.pallas.nn_kernel import (
    knn_pallas,
    nearest_neighbors_pallas,
    nearest_neighbors_pallas3,
)
from icpslam_tpu_torch.ops import nn as tnn

GAP = 2.0**-15


def _exact_d2(q, t, mask):
    d = ((q.astype(np.float64)[:, None] - t.astype(np.float64)[None]) ** 2).sum(-1)
    return np.where(mask[None, :], d, np.inf)


def _separated(d, rank=0):
    """Rows whose rank-th exact d² is separated from its neighbours in the
    sorted order by more than GAP relative (or has no finite neighbour)."""
    s = np.sort(d, axis=1)
    cur = s[:, rank]
    ok = np.ones(len(cur), bool)
    for other in (rank - 1, rank + 1):
        if 0 <= other < s.shape[1]:
            o = s[:, other]
            with np.errstate(invalid="ignore"):
                close = np.abs(o - cur) <= GAP * np.maximum(cur, 1e-30)
            ok &= ~(close & np.isfinite(o))
    return ok


def _port_nn(q, t, mask, valid_len=None):
    vl = None if valid_len is None else torch.tensor(valid_len, dtype=torch.int32)
    res = tnn.nearest_neighbors(
        torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(mask), valid_len=vl
    )
    return res.idx.numpy(), res.dist2.numpy()


def _v3(q, t, mask, valid_len=None):
    vl = None if valid_len is None else jnp.asarray(valid_len, jnp.int32)
    r = nearest_neighbors_pallas3(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask), valid_len=vl,
        bq=256, bt=128, interpret=True,
    )
    return np.asarray(r.idx), np.asarray(r.dist2)


def _xla(q, t, mask):
    r = jnn.nearest_neighbors(jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask), use_pallas=False)
    return np.asarray(r.idx), np.asarray(r.dist2)


def _case(name):
    rng = np.random.RandomState({"random": 1, "masked": 2, "far": 3, "valid_len": 4}[name])
    q = rng.randn(512, 3).astype(np.float32) * 3
    t = rng.randn(512, 3).astype(np.float32) * 3
    mask = np.ones(512, bool)
    valid_len = None
    if name == "masked":
        mask = rng.rand(512) > 0.3
    elif name == "far":
        off = np.array([1000.0, -1000.0, 1000.0], np.float32)
        q, t = q + off, t + off
    elif name == "valid_len":
        valid_len = 200
        mask = np.arange(512) < valid_len
    return q, t, mask, valid_len


CASES = ["random", "masked", "far", "valid_len"]


@pytest.mark.parametrize("name", CASES)
def test_nn_matches_pallas_v3(name):
    q, t, mask, vl = _case(name)
    idx, d2 = _port_nn(q, t, mask, vl)
    ridx, rd2 = _v3(q, t, mask, vl)
    np.testing.assert_allclose(d2, rd2, rtol=1e-6, atol=1e-6)
    sep = _separated(_exact_d2(q, t, mask))
    assert sep.mean() > 0.95
    np.testing.assert_array_equal(idx[sep], ridx[sep])


@pytest.mark.parametrize("name", CASES)
def test_nn_matches_xla_path(name):
    q, t, mask, vl = _case(name)
    idx, d2 = _port_nn(q, t, mask, vl)
    ridx, rd2 = _xla(q, t, mask)
    # at 1 km from the origin the centred matmul form still cancels at
    # |q|·|t|·2⁻²⁴ of the centred coordinates — 1e-4 covers it
    np.testing.assert_allclose(d2, rd2, rtol=0, atol=1e-4)
    sep = _separated(_exact_d2(q, t, mask))
    np.testing.assert_array_equal(idx[sep], ridx[sep])


def test_nn_valid_len_zero_and_all_masked():
    q, t, _, _ = _case("random")
    none = np.zeros(512, bool)
    for vl in (0, None):
        idx, d2 = _port_nn(q, t, none, vl)
        _, rd2 = _v3(q, t, none, vl)
        # no live target: inf everywhere; the port defines the index as 0
        # (v3's index is arbitrary there)
        assert np.all(np.isinf(d2)) and np.all(np.isinf(rd2))
        np.testing.assert_array_equal(idx, 0)


def test_nn_exact_against_float64():
    # the subtraction form picks the exact float64 nearest neighbour
    q, t, mask, _ = _case("far")
    idx, d2 = _port_nn(q, t, mask)
    d = _exact_d2(q, t, mask)
    sep = _separated(d)
    np.testing.assert_array_equal(idx[sep], d.argmin(1)[sep])


@pytest.mark.parametrize("name", CASES)
def test_nn_matmul_matches_pallas_v1(name):
    q, t, mask, vl = _case(name)
    res = tnn.nearest_neighbors_matmul(
        torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(mask),
        valid_len=None if vl is None else torch.tensor(vl, dtype=torch.int32),
    )
    idx, d2 = res.idx.numpy(), res.dist2.numpy()
    r = nearest_neighbors_pallas(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask),
        valid_len=None if vl is None else jnp.asarray(vl, jnp.int32),
        bq=256, bt=128, interpret=True,
    )
    ridx, rd2 = np.asarray(r.idx), np.asarray(r.dist2)
    center = q.astype(np.float64).mean(0)
    qc2 = ((q - center) ** 2).sum(-1)
    tc2 = ((t - center) ** 2).sum(-1)
    tol = 4e-7 * (qc2 + tc2[idx]) + 1e-6
    assert np.all(np.abs(d2 - rd2) <= tol)
    assert np.all(mask[idx])
    exact = _exact_d2(q, t, mask)
    rows = np.arange(len(q))
    differ = idx != ridx
    assert np.all(np.abs(exact[rows, idx] - exact[rows, ridx])[differ] <= 2 * tol[differ])
    # the matmul form still picks the exact nearest neighbour wherever the
    # runner-up is farther than the rounding
    sep = _separated(exact)
    assert (idx[sep] == exact.argmin(1)[sep]).mean() > 0.99


def test_nn_matmul_all_masked():
    q, t, _, _ = _case("random")
    res = tnn.nearest_neighbors_matmul(
        torch.from_numpy(q), torch.from_numpy(t), torch.zeros(512, dtype=torch.bool)
    )
    assert torch.isinf(res.dist2).all() and (res.idx == 0).all()


def _port_knn(q, t, mask, k):
    idx, d2 = tnn.knn(torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(mask), k)
    return idx.numpy(), d2.numpy()


@pytest.mark.parametrize("k", [5, 10])
@pytest.mark.parametrize("ref", ["knn_pallas", "xla"])
def test_knn_matches_jax(k, ref):
    rng = np.random.RandomState(10 + k)
    q = rng.randn(512, 3).astype(np.float32) * 2
    t = rng.randn(512, 3).astype(np.float32) * 2
    mask = rng.rand(512) > 0.2
    idx, d2 = _port_knn(q, t, mask, k)
    if ref == "knn_pallas":
        r = knn_pallas(jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask), k,
                       bq=256, bt=128, interpret=True)
    else:
        r = jnn.knn(jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask), k, approx=False)
    ridx, rd2 = np.asarray(r[0]), np.asarray(r[1])
    np.testing.assert_allclose(d2, rd2, rtol=0, atol=1e-4)
    d = _exact_d2(q, t, mask)
    for rank in range(k):
        sep = _separated(d, rank)
        np.testing.assert_array_equal(idx[sep, rank], ridx[sep, rank])
    assert np.all(np.diff(d2, axis=1) >= 0)


def test_exact_ties_go_to_the_lowest_index():
    # duplicates at both ends of the target array: the plain versions
    # (which the kernels match exactly) order exact ties by index
    rng = np.random.RandomState(21)
    t = rng.randn(300, 3).astype(np.float32)
    t[250:] = t[:50]
    q = t[[260, 10, 120]] + np.float32(0.0)
    mask = np.ones(300, bool)
    idx, d2 = _port_nn(q, t, mask)
    np.testing.assert_array_equal(idx, [10, 10, 120])
    np.testing.assert_array_equal(d2, 0.0)
    kidx, kd2 = _port_knn(q, t, mask, 4)
    np.testing.assert_array_equal(kidx[:2, :2], [[10, 260], [10, 260]])
    np.testing.assert_array_equal(kd2[:2, :2], 0.0)
    assert np.all(np.diff(kd2, axis=1) >= 0)


def test_knn_self_query_and_fewer_live_than_k():
    rng = np.random.RandomState(20)
    pts = rng.randn(512, 3).astype(np.float32)
    mask = np.zeros(512, bool)
    mask[[3, 100, 400]] = True
    k = 5
    idx, d2 = _port_knn(pts, pts, mask, k)
    r = knn_pallas(jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(mask), k,
                   bq=256, bt=128, interpret=True)
    ridx, rd2 = np.asarray(r[0]), np.asarray(r[1])
    assert np.all(np.isinf(d2[:, 3:])) and np.all(np.isinf(rd2[:, 3:]))
    np.testing.assert_array_equal(idx[:, 3:], 0)
    np.testing.assert_array_equal(ridx[:, 3:], 0)
    np.testing.assert_allclose(d2[:, :3], rd2[:, :3], rtol=0, atol=1e-4)
    # a live self-query finds itself first, at exactly zero
    for i in (3, 100, 400):
        assert idx[i, 0] == i and d2[i, 0] == 0.0



def _old_form_nn(q, t, mask):
    """The plain versions' blocked d² as it was built before
    ``_block_sqdist``: one (n, m, 3) difference tensor, then ``torch.where``
    over the mask; the argmin and the k smallest (d², index) keys of it."""
    center = q.mean(0)
    qc, tc = q - center, t - center
    d2 = tnn._sqdist(tc[None, :, :] - qc[:, None, :])
    return torch.where(mask[None, :], d2, tnn._INF), qc, tc


@pytest.mark.parametrize("k", [1, 8])
def test_block_sqdist_bit_equal_to_the_difference_tensor_form(k):
    # a coarse grid gives many exact d² ties; some targets are duplicated
    # and some masked, so the argmin and the (d², index) keys must break
    # the ties in the same way as before
    rng = np.random.RandomState(22)
    t = (rng.randint(-6, 7, (700, 3)) * 0.25).astype(np.float32)
    t[600:] = t[:100]
    q = np.concatenate([t[rng.randint(0, 700, 200)],
                        rng.randn(200, 3).astype(np.float32) * 2])
    mask = rng.rand(700) > 0.2
    qt, tt, mt = torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(mask)
    old, qc, tc = _old_form_nn(qt, tt, mt)
    new = tnn._block_sqdist(tc, qc).masked_fill_(~mt[None, :], tnn._INF)
    assert torch.equal(new.view(torch.int32), old.view(torch.int32))
    if k == 1:
        res = tnn.nearest_neighbors_plain(qt, tt, mt)
        idx = old.argmin(1)
        assert torch.equal(res.idx, idx)
        assert torch.equal(res.dist2.view(torch.int32),
                           tnn._sqdist(tc[idx] - qc).view(torch.int32))
    else:
        idx, d2 = tnn.knn_plain(qt, tt, mt, k)
        vals, oidx = tnn._smallest_k(old, k)
        assert torch.equal(idx, oidx)
        assert torch.equal(d2.view(torch.int32), vals.view(torch.int32))
    ties = (old == old.min(1, keepdim=True).values).sum(1)
    assert int((ties > 1).sum()) > 50   # the case holds many exact ties
