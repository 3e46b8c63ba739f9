"""The port's PCG and Schur linear solvers and the bucketed 'auto' rule
against the JAX ones (``icpslam_tpu/graph/pose_graph.py``, ``graph/schur.py``).

Graphs are made with numpy from a seed and handed to both packages:

- the 12-node circle with a loop edge of ``tests/test_graph.py::TestPCGSolver``,
  solved by PCG in GN and LM: poses within 1e-3 of JAX's;
- dead nodes: PCG's step and poses stay exactly 0 there, and
  ``optimize_bucketed`` on 4 live nodes solves the 8-node bucket;
- ``optimize_bucketed`` with 'auto' at K = 512, E = 2,048: 300 live nodes
  (the node count takes the 512 bucket) and 200 nodes with 1,100 edges (the
  edge count does), against JAX's ``optimize`` with 'auto' on the 512-node
  prefix, the branch its ``optimize_bucketed`` takes there: both resolve to
  PCG, poses within 1e-3;
- the 16-node graph of ``TestSchurSolver`` (chunk 4, separator capacity
  10) by Schur: poses within 1e-4 of JAX's; at capacity 2 the separators
  overflow and the step is the direct one, bit for bit;
- ``separator_mask`` and ``schur_solve`` against JAX's.
"""

import torch

# one intra-op thread per test worker: the suite runs several pytest
# workers on the host's cores beside XLA's own pool
torch.set_num_threads(1)

import jax.numpy as jnp
import numpy as np
import pytest

from icpslam_tpu.geometry import se3 as jse3
from icpslam_tpu.graph import pose_graph as jpg
from icpslam_tpu.graph import schur as jschur
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.graph import pose_graph as tpg
from icpslam_tpu_torch.graph import schur as tschur


def _quat(rng, n, scale):
    axis = rng.randn(n, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = rng.randn(n) * scale
    return np.c_[np.cos(ang / 2), axis * np.sin(ang / 2)[:, None]].astype(np.float32)


def _circle(n, radius=5.0):
    theta = np.linspace(0, 2 * np.pi, n, endpoint=False)
    t = np.c_[radius * np.cos(theta), radius * np.sin(theta), np.zeros(n)].astype(np.float32)
    yaw = theta + np.pi / 2
    z = np.zeros_like(yaw)
    q = np.stack([np.cos(yaw / 2), z, z, np.sin(yaw / 2)], -1).astype(np.float32)
    return t, q


def _graph(t, q, pairs, K, E, rng, noise=0.0, drift=0.0, info=100.0, anchor_first=False):
    """Numpy pose graph over the true poses ``(t, q)`` (n ≤ K live nodes):
    edges ``pairs`` measured from the truth (with ``noise``), the initial
    guess the truth with cumulative ``drift``. Returns ``(t0, q0, edges,
    mask)``, edges as a dict of numpy arrays in EdgeSet order."""
    n = t.shape[0]
    t_all = np.zeros((K, 3), np.float32)
    q_all = np.tile(np.array([1, 0, 0, 0], np.float32), (K, 1))
    t_all[:n], q_all[:n] = t, q
    truth = jse3.Pose(t=jnp.asarray(t_all), q=jnp.asarray(q_all))
    ei = np.zeros(E, np.int32)
    ej = np.zeros(E, np.int32)
    ei[: len(pairs)], ej[: len(pairs)] = np.array(pairs, np.int32).T
    rel = jse3.relative(jse3.Pose(t=truth.t[ei], q=truth.q[ei]),
                        jse3.Pose(t=truth.t[ej], q=truth.q[ej]))
    if noise:
        rel = jse3.compose(rel, jse3.se3_exp(jnp.asarray(rng.randn(E, 6).astype(np.float32) * noise)))
    valid = np.arange(E) < len(pairs)
    edges = dict(
        i=ei, j=ej, rel_t=np.asarray(rel.t), rel_q=np.asarray(rel.q),
        info=np.tile((info * np.eye(6)).astype(np.float32), (E, 1, 1)), valid=valid,
        count=np.int32(len(pairs)), overflow=np.int32(0),
    )
    d = np.zeros((K, 6), np.float32)
    if drift:
        d[:n] = np.cumsum(rng.randn(n, 6) * drift, axis=0)
    if anchor_first:
        d[0] = 0.0
    init = jse3.normalize(jse3.compose(truth, jse3.se3_exp(jnp.asarray(d))))
    return np.asarray(init.t), np.asarray(init.q), edges, np.arange(K) < n


def _jax(t, q, edges, mask):
    return (jse3.Pose(t=jnp.asarray(t), q=jnp.asarray(q)),
            jpg.EdgeSet(**{k: jnp.asarray(v) for k, v in edges.items()}), jnp.asarray(mask))


def _port(t, q, edges, mask):
    return (Pose(t=torch.tensor(t), q=torch.tensor(q)),
            tpg.EdgeSet(**{k: torch.tensor(np.asarray(v)) for k, v in edges.items()}),
            torch.tensor(mask))


@pytest.fixture(scope="module")
def circle12():
    """TestPCGSolver's graph: 12 nodes, a closed chain, node 0 at the truth."""
    t, q = _circle(12)
    pairs = [(k, k + 1) for k in range(11)] + [(11, 0)]
    return _graph(t, q, pairs, 12, 16, np.random.RandomState(5), drift=0.02, anchor_first=True)


@pytest.mark.parametrize("mode", ["gn", "lm"])
def test_pcg_matches_jax(circle12, mode):
    kw = dict(iterations=15, mode=mode, linear_solver="pcg", cg_iterations=100)
    j_nodes, j_stats = jpg.optimize(*_jax(*circle12), **kw)
    calls = tpg.optimize.pcg_solves
    t_nodes, t_stats = tpg.optimize(*_port(*circle12), **kw)
    assert tpg.optimize.pcg_solves == calls + 1
    np.testing.assert_allclose(t_nodes.t.numpy(), np.asarray(j_nodes.t), rtol=0, atol=1e-3)
    np.testing.assert_allclose(t_nodes.q.numpy(), np.asarray(j_nodes.q), rtol=0, atol=1e-3)
    assert float(t_stats.final_cost) < float(t_stats.initial_cost) * 1e-3
    # and PCG reaches the direct solve's poses, as in JAX's own test
    direct, _ = tpg.optimize(*_port(*circle12), iterations=15, mode=mode)
    np.testing.assert_allclose(t_nodes.t.numpy(), direct.t.numpy(), rtol=0, atol=5e-3)


@pytest.fixture(scope="module")
def dead8():
    """Four live circle nodes in an 8-node store, noisy chain edges."""
    t, q = _circle(4)
    pairs = [(k, k + 1) for k in range(3)]
    return _graph(t, q, pairs, 8, 8, np.random.RandomState(6), noise=0.02, drift=0.02)


def test_pcg_dead_nodes_stay_zero(dead8):
    t, q, edges, mask = dead8
    nodes, es, m = _port(t, q, edges, mask)
    for lam in (0.0, torch.tensor(1e-4)):
        delta = tpg._pcg_delta(nodes, es, m, lam)
        assert torch.count_nonzero(delta[4:]) == 0
        assert torch.count_nonzero(delta[:4]) > 0
    opt, _ = tpg.optimize(nodes, es, m, iterations=5, mode="gn", linear_solver="pcg")
    assert torch.equal(opt.t[4:], nodes.t[4:]) and torch.equal(opt.q[4:], nodes.q[4:])
    assert torch.isfinite(opt.t).all()


@pytest.mark.parametrize("mode", ["gn", "lm"])
def test_pcg_live_size_equals_bucket_size(dead8, mode):
    t, q, edges, mask = dead8
    nodes, es, m = _port(t, q, edges, mask)
    kw = dict(iterations=5, mode=mode)
    live, _ = tpg.optimize_bucketed(nodes, es, m, 4, 3, min_bucket=8, linear_solver="pcg", **kw)
    bucket, _ = tpg.optimize(nodes, es, m, linear_solver="pcg", **kw)
    np.testing.assert_allclose(live.t.numpy(), bucket.t.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(live.q.numpy(), bucket.q.numpy(), rtol=0, atol=1e-5)
    assert torch.equal(live.t[4:], nodes.t[4:])


def _long_graph(n, n_edges, seed):
    """n live nodes along a noisy loop of 3 laps in a 512-node store with a
    2,048-edge capacity: the chain plus loop edges between nodes one or
    more laps apart, all measured with noise; the initial guess drifts."""
    rng = np.random.RandomState(seed)
    theta = np.linspace(0, 6 * np.pi, n, endpoint=False)
    t = np.c_[20 * np.cos(theta), 20 * np.sin(theta), 0.5 * np.sin(3 * theta)].astype(np.float32)
    q = _quat(rng, n, 0.2)
    pairs = [(k, k + 1) for k in range(n - 1)]
    lap = n // 3
    while len(pairs) < n_edges:
        a = int(rng.randint(0, n - lap))
        b = min(n - 1, a + lap * int(rng.randint(1, 3)) + int(rng.randint(-3, 4)))
        pairs.append((a, b))
    return _graph(t, q, pairs, 512, 2048, rng, noise=0.01, drift=0.01)


@pytest.mark.parametrize("n,n_edges", [(300, 299), (200, 1100)], ids=["300-nodes", "1100-edges"])
def test_auto_rule_against_jax(n, n_edges):
    t, q, edges, mask = _long_graph(n, n_edges, seed=n)
    kw = dict(iterations=3, mode="lm")
    assert tpg.bucket_size(n, n_edges, 512, 2048, 64) == 512
    assert tpg.resolve_linear_solver("auto", 512) == jpg.resolve_linear_solver("auto", 512) == "pcg"
    j_nodes, j_stats = jpg.optimize(*_jax(t, q, edges, mask), linear_solver="auto", **kw)
    calls = tpg.optimize.pcg_solves
    nodes, es, m = _port(t, q, edges, mask)
    t_nodes, t_stats = tpg.optimize_bucketed(nodes, es, m, n, n_edges, linear_solver="auto", **kw)
    assert tpg.optimize.pcg_solves == calls + 1
    np.testing.assert_allclose(t_nodes.t.numpy(), np.asarray(j_nodes.t), rtol=0, atol=1e-3)
    np.testing.assert_allclose(t_nodes.q.numpy(), np.asarray(j_nodes.q), rtol=0, atol=1e-3)
    np.testing.assert_allclose(float(t_stats.final_cost), float(j_stats.final_cost), rtol=1e-3)
    assert float(t_stats.final_cost) < float(t_stats.initial_cost)
    # below the 256-node bucket the same rule is the direct solve
    calls = tpg.optimize.pcg_solves
    tpg.optimize_bucketed(*_port(*_long_graph(40, 39, seed=n)), 40, 39, linear_solver="auto", **kw)
    assert tpg.optimize.pcg_solves == calls


@pytest.fixture(scope="module")
def schur16():
    """TestSchurSolver's graph: a 16-node closed chain with a chunk-crossing
    loop edge (3, 12)."""
    t, q = _circle(16)
    pairs = [(k, k + 1) for k in range(15)] + [(15, 0), (3, 12)]
    return _graph(t, q, pairs, 16, 32, np.random.RandomState(12), drift=0.02)


@pytest.mark.parametrize("mode", ["gn", "lm"])
def test_schur_matches_jax(schur16, mode):
    kw = dict(iterations=12, mode=mode, linear_solver="schur", schur_chunk_size=4,
              schur_sep_capacity=10)
    j_nodes, _ = jpg.optimize(*_jax(*schur16), **kw)
    t_nodes, t_stats = tpg.optimize(*_port(*schur16), **kw)
    np.testing.assert_allclose(t_nodes.t.numpy(), np.asarray(j_nodes.t), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_nodes.q.numpy(), np.asarray(j_nodes.q), rtol=0, atol=1e-4)
    assert float(t_stats.final_cost) < float(t_stats.initial_cost) * 1e-3


@pytest.mark.parametrize("mode", ["gn", "lm"])
def test_schur_fallback_equals_direct(schur16, mode):
    nodes, es, m = _port(*schur16)
    sm = tschur.separator_mask(es.i, es.j, es.valid, 16, 4)
    assert int(sm.sum()) > 2
    kw = dict(iterations=4, mode=mode)
    sch, s_stats = tpg.optimize(nodes, es, m, linear_solver="schur", schur_chunk_size=4,
                                schur_sep_capacity=2, **kw)
    direct, d_stats = tpg.optimize(nodes, es, m, linear_solver="direct", **kw)
    assert torch.equal(sch.t, direct.t) and torch.equal(sch.q, direct.q)
    assert torch.equal(s_stats.final_cost, d_stats.final_cost)


def test_schur_bucketed_runs_at_the_bucket(schur16):
    """'schur' through optimize_bucketed solves the 16-node bucket (chunk 4
    divides it), not the 13-node live prefix, and gives optimize's poses."""
    t, q, edges, mask = schur16
    mask = mask & (np.arange(16) < 13)
    edges = dict(edges, valid=edges["valid"] & (edges["i"] < 13) & (edges["j"] < 13))
    nodes, es, m = _port(t, q, edges, mask)
    kw = dict(iterations=3, mode="lm", linear_solver="schur", schur_chunk_size=4,
              schur_sep_capacity=10)
    got, _ = tpg.optimize_bucketed(nodes, es, m, 13, 13, min_bucket=16, **kw)
    want, _ = tpg.optimize(nodes, es, m, **kw)
    np.testing.assert_allclose(got.t.numpy(), want.t.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.q.numpy(), want.q.numpy(), rtol=0, atol=1e-6)
    assert float((got.t[:13] - nodes.t[:13]).abs().max()) > 1e-3


def test_separator_mask_matches_jax():
    rng = np.random.RandomState(3)
    ei = rng.randint(0, 64, 200).astype(np.int32)
    ej = rng.randint(0, 64, 200).astype(np.int32)
    valid = rng.rand(200) < 0.7
    for cs in (4, 16, 64):
        want = np.asarray(jschur.separator_mask(jnp.asarray(ei), jnp.asarray(ej),
                                                jnp.asarray(valid), 64, cs))
        got = tschur.separator_mask(torch.tensor(ei), torch.tensor(ej), torch.tensor(valid), 64, cs)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cap", [10, 2])
def test_schur_solve_matches_jax(schur16, cap):
    t, q, edges, mask = schur16
    jH, jb = jpg.normal_equations(*_jax(*schur16))
    jsm = jschur.separator_mask(jnp.asarray(edges["i"]), jnp.asarray(edges["j"]),
                                jnp.asarray(edges["valid"]), 16, 4)
    jres = jschur.schur_solve(jH, -jb, jsm, 4, cap)
    tH, tb = tpg.normal_equations(*_port(*schur16))
    tsm = tschur.separator_mask(torch.tensor(edges["i"]), torch.tensor(edges["j"]),
                                torch.tensor(edges["valid"]), 16, 4)
    tres = tschur.schur_solve(tH, -tb, tsm, 4, cap)
    assert bool(tres.ok) == bool(jres.ok) == (cap == 10)
    assert int(tres.n_sep) == int(jres.n_sep)
    if cap == 10:
        scale = np.abs(np.asarray(jres.delta)).max()
        np.testing.assert_allclose(tres.delta.numpy(), np.asarray(jres.delta), rtol=0,
                                   atol=1e-4 * scale)


def test_pcg_solve_reaches_the_solution():
    """pcg_solve on a block-diagonally dominant SPD system: the frozen loop
    stops where JAX's while_loop would, at the solution."""
    rng = np.random.RandomState(0)
    A = rng.randn(60, 60).astype(np.float64)
    H = (A @ A.T / 60 + np.eye(60)).astype(np.float32)
    b = rng.randn(10, 6).astype(np.float32)
    Ht = torch.tensor(H)
    blocks = torch.stack([Ht[6 * k: 6 * k + 6, 6 * k: 6 * k + 6] for k in range(10)])
    x, steps = tpg.pcg_solve(lambda v: (Ht @ v.reshape(60)).reshape(10, 6),
                             torch.linalg.inv(blocks), torch.tensor(b), iterations=200)
    assert 0 < int(steps) < 200
    want = np.linalg.solve(H.astype(np.float64), b.reshape(60).astype(np.float64))
    np.testing.assert_allclose(x.numpy().reshape(60), want, rtol=0, atol=1e-4)
