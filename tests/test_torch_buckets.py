"""The port's graph solves at static shapes, against the shapes they had
before (``icpslam_tpu_torch/graph/pose_graph.py``).

A 40-node noisy loop (a chain plus loop edges) in a 64-node store with a
256-edge capacity; the bucket is 64 (minimum bucket 16). The bucket-shaped
direct and PCG solves (``optimize_bucketed`` → ``solve_bucket``) equal the
solves at the live size — 40 nodes and the live edges — and the window
solve with its start on the device (``optimize_window`` over the whole
edge store) equals the window taken as a host slice of the live edges,
in GN and LM. In float64 they agree within 1e-5 m and 1e-5 in the
quaternion components, the final costs within 1e-4 relative. In float32,
the solves' own precision, they differ by the rounding of a Cholesky
factorization of 384 rows against one of 240 (up to 1.5e-5 m on this
graph after three LM steps, whose anchor weight of 1e6 against an edge
information of 100 makes the system ill-conditioned), so there the
tolerance is 5e-5. These shapes are what ``graph/captured.py`` captures
on the card.
"""

import torch

# one intra-op thread per test worker: the suite runs several pytest
# workers on the host's cores beside XLA's own pool
torch.set_num_threads(1)

import numpy as np
import pytest

from icpslam_tpu_torch.geometry import se3
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.graph import captured
from icpslam_tpu_torch.graph import pose_graph as tpg

K, E, N = 64, 256, 40
TOL = {torch.float64: 1e-5, torch.float32: 5e-5}


@pytest.fixture(scope="module", params=[torch.float64, torch.float32], ids=["f64", "f32"])
def graph(request):
    g = _graph()
    dt = request.param
    nodes, edges = g[0], g[1]
    nodes = Pose(nodes.t.to(dt), nodes.q.to(dt))
    edges = edges._replace(rel_t=edges.rel_t.to(dt), rel_q=edges.rel_q.to(dt),
                           info=edges.info.to(dt))
    return nodes, edges, g[2], g[3]


def _graph():
    rng = np.random.RandomState(4)
    theta = np.linspace(0, 4 * np.pi, N, endpoint=False)
    t = np.c_[8 * np.cos(theta), 8 * np.sin(theta), 0.3 * np.sin(2 * theta)]
    yaw = theta + np.pi / 2
    z = np.zeros(N)
    q = np.stack([np.cos(yaw / 2), z, z, np.sin(yaw / 2)], -1)
    truth = Pose(torch.tensor(np.r_[t, np.zeros((K - N, 3))], dtype=torch.float32),
                 torch.tensor(np.r_[q, np.tile([1.0, 0, 0, 0], (K - N, 1))], dtype=torch.float32))
    pairs = [(k, k + 1) for k in range(N - 1)] + [(k, k + N // 2) for k in range(0, N // 2, 3)]
    edges = tpg.empty_edges(E)
    for a, b in pairs:
        rel = se3.relative(se3.index(truth, a), se3.index(truth, b))
        rel = se3.compose(rel, se3.se3_exp(torch.tensor(rng.randn(6) * 0.01, dtype=torch.float32)))
        edges = tpg.add_edge(edges, a, b, rel, 100.0 * torch.eye(6))
    # a stale index past the live nodes in an invalid slot, as compaction leaves them
    edges = edges._replace(i=edges.i.index_fill(0, torch.tensor([E - 1]), N + 7))
    drift = np.zeros((K, 6))
    drift[1:N] = np.cumsum(rng.randn(N - 1, 6) * 0.01, axis=0)
    nodes = se3.normalize(se3.compose(truth, se3.se3_exp(torch.tensor(drift, dtype=torch.float32))))
    return nodes, edges, torch.arange(K) < N, len(pairs)


def _live_edges(edges, m):
    return tpg.EdgeSet(*(x[:m] if x.dim() else x for x in edges))


def _close(a: Pose, b: Pose):
    tol = TOL[a.t.dtype]
    np.testing.assert_allclose(a.t.numpy(), b.t.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(a.q.numpy(), b.q.numpy(), rtol=0, atol=tol)


@pytest.mark.parametrize("solver", ["direct", "pcg"])
@pytest.mark.parametrize("mode", ["gn", "lm"])
def test_bucket_solve_equals_live_size(graph, solver, mode):
    nodes, edges, mask, n_edges = graph
    assert tpg.bucket_size(N, n_edges, K, E, 16) == K
    kw = dict(iterations=3, mode=mode)
    got, stats = tpg.optimize_bucketed(nodes, edges, mask, N, n_edges, min_bucket=16,
                                       linear_solver=solver, **kw)
    live, live_stats = tpg.optimize(Pose(nodes.t[:N], nodes.q[:N]), _live_edges(edges, n_edges),
                                    mask[:N], linear_solver=solver, **kw)
    _close(Pose(got.t[:N], got.q[:N]), live)
    assert torch.equal(got.t[N:], nodes.t[N:]) and torch.equal(got.q[N:], nodes.q[N:])
    np.testing.assert_allclose(float(stats.final_cost), float(live_stats.final_cost), rtol=1e-4)
    assert float(stats.final_cost) < float(stats.initial_cost)


def _host_slice_window(nodes, edges, mask, count, W, iterations, mode):
    """The window solve as the port had it: ``start`` a host int, the
    window a slice, the live edges only."""
    start = count - W
    local = (torch.arange(W) + start < count) & mask[start:start + W]

    def step(nds, lam):
        H, b = tpg._window_normal_equations(nds, edges, start, W, local, 0.0)
        win = Pose(nds.t[start:start + W], nds.q[start:start + W])
        new = tpg._solve_and_update(win, H, b, lam + 1e-9, local)
        t, q = nds.t.clone(), nds.q.clone()
        t[start:start + W], q[start:start + W] = new.t, new.q
        return Pose(t, q)

    return tpg._gn_or_lm(step, nodes, edges, iterations, mode, 1e-4)


@pytest.mark.parametrize("mode", ["gn", "lm"])
def test_window_with_device_start_equals_host_slice(graph, mode):
    nodes, edges, mask, n_edges = graph
    W = 16
    calls = tpg.optimize_window.calls
    got, stats = tpg.optimize_window(nodes, edges, mask, torch.tensor(N, dtype=torch.int32), W,
                                     iterations=3, mode=mode)
    assert tpg.optimize_window.calls == calls + 1
    want, want_stats = _host_slice_window(nodes, _live_edges(edges, n_edges), mask, N, W, 3, mode)
    _close(got, want)
    np.testing.assert_allclose(float(stats.final_cost), float(want_stats.final_cost), rtol=1e-4)
    moved = (got.t - nodes.t).norm(dim=-1) > 1e-6
    assert moved[N - W:N].all() and not moved[:N - W].any() and not moved[N:].any()


def test_captured_solves_need_the_card():
    assert captured.for_device("cpu") is None
    with pytest.raises(ValueError, match="CUDA"):
        captured.CapturedSolves("cpu")
