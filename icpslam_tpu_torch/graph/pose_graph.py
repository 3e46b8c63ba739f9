"""SE(3) pose-graph optimization, the subset the slice needs (port of
``icpslam_tpu/graph/pose_graph.py``).

Edge residuals ``log(Z⁻¹ X_i⁻¹ X_j)`` with closed-form right-perturbation
Jacobians, dense block normal equations assembled with ``index_put_``
accumulation, the node-0 gauge anchor, and GN / LM with a dense Cholesky
(``torch.linalg.cholesky_ex``, no host check). :func:`optimize_bucketed`
solves at the live size, which on append-only stores equals the JAX
bucketed solve; it raises where the JAX ``'auto'`` rule would pick PCG.
:func:`optimize_window` is the incremental solve of the trailing window,
conditioned on the frozen prefix. PCG, Schur and marginalization are not
ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from icpslam_tpu_torch.geometry import se3
from icpslam_tpu_torch.geometry.se3 import Pose


class EdgeSet(NamedTuple):
    i: torch.Tensor      # (E,) int32
    j: torch.Tensor      # (E,) int32
    rel_t: torch.Tensor  # (E, 3)
    rel_q: torch.Tensor  # (E, 4)
    info: torch.Tensor   # (E, 6, 6)
    valid: torch.Tensor  # (E,) bool
    count: torch.Tensor  # int32
    overflow: torch.Tensor  # int32

    @property
    def capacity(self) -> int:
        return self.i.shape[0]

    def rel(self) -> Pose:
        return Pose(t=self.rel_t, q=self.rel_q)


class SolveStats(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    iterations: torch.Tensor


def empty_edges(capacity: int, dtype=torch.float32, device=None) -> EdgeSet:
    ident = se3.identity((capacity,), dtype, device)
    return EdgeSet(
        i=torch.zeros((capacity,), dtype=torch.int32, device=device),
        j=torch.zeros((capacity,), dtype=torch.int32, device=device),
        rel_t=ident.t,
        rel_q=ident.q,
        info=torch.eye(6, dtype=dtype, device=device).expand(capacity, 6, 6).contiguous(),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        count=torch.tensor(0, dtype=torch.int32, device=device),
        overflow=torch.tensor(0, dtype=torch.int32, device=device),
    )


def add_edge(edges: EdgeSet, i, j, rel: Pose, info: torch.Tensor, enable=True) -> EdgeSet:
    """Append one edge (no-op unless ``enable``; counted in ``overflow``
    when dropped only because the store is full)."""
    dev = edges.i.device
    want = torch.as_tensor(enable, device=dev)
    room = edges.count < edges.capacity
    on = want & room
    idx = torch.clamp(edges.count, max=edges.capacity - 1).long()[None]

    def upd(arr, val):
        val = torch.as_tensor(val, device=dev).to(arr.dtype)
        return torch.where(on, arr.index_copy(0, idx, val[None]), arr)

    return EdgeSet(
        i=upd(edges.i, i),
        j=upd(edges.j, j),
        rel_t=upd(edges.rel_t, rel.t),
        rel_q=upd(edges.rel_q, rel.q),
        info=upd(edges.info, info),
        valid=upd(edges.valid, True),
        count=torch.where(on, edges.count + 1, edges.count),
        overflow=edges.overflow + (want & ~room).to(torch.int32),
    )


def _endpoints(nodes: Pose, edges: EdgeSet):
    i, j = edges.i.long(), edges.j.long()
    return Pose(t=nodes.t[i], q=nodes.q[i]), Pose(t=nodes.t[j], q=nodes.q[j])


def edge_residuals(nodes: Pose, edges: EdgeSet) -> torch.Tensor:
    Xi, Xj = _endpoints(nodes, edges)
    err = se3.compose(se3.inverse(edges.rel()), se3.relative(Xi, Xj))
    r = se3.se3_log(err)
    return torch.where(edges.valid[:, None], r, 0.0)


def graph_cost(nodes: Pose, edges: EdgeSet) -> torch.Tensor:
    r = edge_residuals(nodes, edges)
    return torch.einsum("ei,eij,ej->e", r, edges.info, r).sum()


def _edge_jacobians(nodes: Pose, edges: EdgeSet):
    """Residual and Jacobians wrt right-perturbations: ``J_j = Jr⁻¹(r)``,
    ``J_i = −Jr⁻¹(r)·Ad(Xj⁻¹ Xi)``."""
    Xi, Xj = _endpoints(nodes, edges)
    err = se3.compose(se3.inverse(edges.rel()), se3.relative(Xi, Xj))
    r = se3.se3_log(err)
    Jr_inv = se3.se3_right_jacobian_inv(r)
    Ji = -(Jr_inv @ se3.adjoint(se3.relative(Xj, Xi)))
    return r, Ji, Jr_inv


def normal_equations(
    nodes: Pose, edges: EdgeSet, node_mask: torch.Tensor, anchor_weight: float = 1e6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, 6, K, 6) H and (K, 6) b, with dead nodes on an identity diagonal
    and node 0 anchored (gauge fix)."""
    K = nodes.t.shape[0]
    dt, dev = nodes.t.dtype, nodes.t.device
    r, Ji, Jj = _edge_jacobians(nodes, edges)
    info = edges.info * edges.valid.to(dt)[:, None, None]
    JiT_O = Ji.mT @ info
    JjT_O = Jj.mT @ info
    Hii, Hij, Hjj = JiT_O @ Ji, JiT_O @ Jj, JjT_O @ Jj
    ei, ej = edges.i.long(), edges.j.long()
    H = torch.zeros((K, K, 6, 6), dtype=dt, device=dev)
    H.index_put_((ei, ei), Hii, accumulate=True)
    H.index_put_((ei, ej), Hij, accumulate=True)
    H.index_put_((ej, ei), Hij.mT, accumulate=True)
    H.index_put_((ej, ej), Hjj, accumulate=True)
    b = torch.zeros((K, 6), dtype=dt, device=dev)
    b.index_add_(0, ei, (JiT_O @ r[..., None])[..., 0])
    b.index_add_(0, ej, (JjT_O @ r[..., None])[..., 0])
    eye6 = torch.eye(6, dtype=dt, device=dev)
    diag = torch.arange(K, device=dev)
    H[diag, diag] += (~node_mask).to(dt)[:, None, None] * eye6
    H[0, 0] += anchor_weight * eye6
    b = b * node_mask[:, None]
    return H.permute(0, 2, 1, 3), b


def _solve_and_update(nodes: Pose, H: torch.Tensor, b: torch.Tensor, damping, node_mask):
    """Damped dense Cholesky step; ``damping`` may be a 0-d tensor."""
    K = nodes.t.shape[0]
    dt, dev = nodes.t.dtype, nodes.t.device
    eye6 = torch.eye(6, dtype=dt, device=dev)
    diag = torch.arange(K, device=dev)
    blocks = H[diag, :, diag, :]
    scale = torch.diagonal(blocks, dim1=-2, dim2=-1).sum(-1) / 6.0
    Hd = H.clone()
    Hd[diag, :, diag, :] = blocks + (damping * torch.clamp(scale, min=1e-6))[:, None, None] * eye6
    L, _ = torch.linalg.cholesky_ex(Hd.reshape(K * 6, K * 6))
    delta = torch.cholesky_solve(-b.reshape(K * 6, 1), L).reshape(K, 6)
    delta = delta * node_mask[:, None]
    return se3.normalize(se3.compose(nodes, se3.se3_exp(delta))), delta


def resolve_linear_solver(linear_solver: str, n_nodes: int) -> str:
    if linear_solver == "auto":
        return "direct" if n_nodes <= 256 else "pcg"
    return linear_solver


def _not_ported(solver: str) -> NotImplementedError:
    return NotImplementedError(
        f"linear_solver='{solver}' is not ported yet — ROADMAP.md Queue 1, "
        "'PCG and the 'auto' rule above 256 nodes' / 'Schur and the deferred solve'"
    )


def optimize(
    nodes: Pose,
    edges: EdgeSet,
    node_mask: torch.Tensor,
    iterations: int = 10,
    mode: str = "lm",
    init_damping: float = 1e-4,
    linear_solver: str = "direct",
) -> Tuple[Pose, SolveStats]:
    """GN (fixed steps) or LM (accept/reject with adaptive damping, kept on
    the device with ``torch.where``), direct solver only."""
    solver = resolve_linear_solver(linear_solver, nodes.t.shape[0])
    if solver != "direct":
        raise _not_ported(solver)

    def step(nds, lam):
        H, b = normal_equations(nds, edges, node_mask)
        return _solve_and_update(nds, H, b, lam, node_mask)[0]

    return _gn_or_lm(step, nodes, edges, iterations, mode, init_damping)


def _gn_or_lm(step, nodes: Pose, edges: EdgeSet, iterations: int, mode: str, init_damping: float):
    """``iterations`` fixed GN steps (``step(nodes, 0.0)``) or LM steps that
    are kept only when they lower the graph's cost, the damping halved on
    accept and quadrupled on reject — all on the device, no host read."""
    c0 = graph_cost(nodes, edges)
    if mode == "gn":
        for _ in range(iterations):
            nodes = step(nodes, 0.0)
        return nodes, SolveStats(c0, graph_cost(nodes, edges), torch.tensor(iterations))

    lam = torch.tensor(init_damping, dtype=nodes.t.dtype, device=nodes.t.device)
    cost = c0
    for _ in range(iterations):
        cand = step(nodes, lam)
        c_new = graph_cost(cand, edges)
        accept = c_new < cost
        nodes = se3.where(accept, cand, nodes)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9), torch.clamp(lam * 4.0, max=1e6))
        cost = torch.where(accept, c_new, cost)
    return nodes, SolveStats(c0, cost, torch.tensor(iterations))


def live_edges(edges: EdgeSet, edge_count: int) -> EdgeSet:
    """The first ``edge_count`` edges (at least one; a host int). The
    edges past the count are invalid and add nothing to any solve."""
    m = max(edge_count, 1)
    return EdgeSet(
        i=edges.i[:m], j=edges.j[:m], rel_t=edges.rel_t[:m], rel_q=edges.rel_q[:m],
        info=edges.info[:m], valid=edges.valid[:m], count=edges.count,
        overflow=edges.overflow,
    )


def bucket_size(node_count: int, edge_count: int, K: int, E: int, min_bucket: int) -> int:
    """The JAX ``optimize_bucketed`` bucket: the smallest power-of-two node
    prefix (≥ ``min_bucket``) that holds the live nodes and edges."""
    kb = min(min_bucket, K)
    buckets = []
    while kb < K:
        buckets.append(kb)
        kb *= 2
    buckets.append(K)
    for b in buckets:
        if node_count <= b and edge_count <= max(1, (E * b) // K):
            return b
    return K


def optimize_bucketed(
    nodes: Pose,
    edges: EdgeSet,
    node_mask: torch.Tensor,
    node_count: int,
    edge_count: int,
    min_bucket: int = 64,
    linear_solver: str = "direct",
    **kw,
) -> Tuple[Pose, SolveStats]:
    """Solve the live prefix (``node_count`` nodes, ``edge_count`` edges —
    host ints). On append-only stores the dead nodes and invalid edges of
    a larger JAX bucket contribute decoupled identity blocks and zero
    residuals, so the live-size solve gives the same poses. Raises where
    JAX's bucket would resolve ``linear_solver`` to anything but direct."""
    K, E = nodes.t.shape[0], edges.i.shape[0]
    bucket = bucket_size(node_count, edge_count, K, E, min_bucket)
    solver = resolve_linear_solver(linear_solver, bucket)
    if solver != "direct":
        raise _not_ported(solver)
    n = max(node_count, 1)
    opt, stats = optimize(
        Pose(t=nodes.t[:n], q=nodes.q[:n]), live_edges(edges, edge_count), node_mask[:n],
        linear_solver="direct", **kw,
    )
    full = Pose(t=nodes.t.clone(), q=nodes.q.clone())
    full.t[:n] = opt.t
    full.q[:n] = opt.q
    return full, stats


def _window_normal_equations(
    nodes: Pose,
    edges: EdgeSet,
    start: int,
    window: int,
    local_mask: torch.Tensor,
    anchor_weight: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W, 6, W, 6) H and (W, 6) b of the window ``[start, start+W)``.

    Exact conditioning on the frozen prefix: an edge endpoint outside the
    window has its Jacobian zeroed, which removes its rows and columns
    from H while its residual stays evaluated at the frozen pose — an
    edge into the prefix becomes a unary prior on its in-window endpoint.
    Window-relative indices are clipped to ``[0, W)``; a clipped endpoint
    has a zero Jacobian, so what it adds is zero. The gauge anchor goes
    on window node 0 with ``anchor_weight`` (0 unless ``start == 0``).
    """
    W = window
    dt, dev = nodes.t.dtype, nodes.t.device
    r, Ji, Jj = _edge_jacobians(nodes, edges)
    ei, ej = edges.i.long(), edges.j.long()
    in_i = ((ei >= start) & (ei < start + W)).to(dt)
    in_j = ((ej >= start) & (ej < start + W)).to(dt)
    info = edges.info * edges.valid.to(dt)[:, None, None]
    Ji = Ji * in_i[:, None, None]
    Jj = Jj * in_j[:, None, None]
    ci = torch.clamp(ei - start, 0, W - 1)
    cj = torch.clamp(ej - start, 0, W - 1)
    JiT_O = Ji.mT @ info
    JjT_O = Jj.mT @ info
    Hii, Hij, Hjj = JiT_O @ Ji, JiT_O @ Jj, JjT_O @ Jj
    H = torch.zeros((W, W, 6, 6), dtype=dt, device=dev)
    H.index_put_((ci, ci), Hii, accumulate=True)
    H.index_put_((ci, cj), Hij, accumulate=True)
    H.index_put_((cj, ci), Hij.mT, accumulate=True)
    H.index_put_((cj, cj), Hjj, accumulate=True)
    b = torch.zeros((W, 6), dtype=dt, device=dev)
    b.index_add_(0, ci, (JiT_O @ r[..., None])[..., 0])
    b.index_add_(0, cj, (JjT_O @ r[..., None])[..., 0])
    eye6 = torch.eye(6, dtype=dt, device=dev)
    diag = torch.arange(W, device=dev)
    H[diag, diag] += (~local_mask).to(dt)[:, None, None] * eye6
    b = b * local_mask[:, None]
    if anchor_weight:
        H[0, 0] += anchor_weight * eye6
    return H.permute(0, 2, 1, 3), b


def optimize_window(
    nodes: Pose,
    edges: EdgeSet,
    node_mask: torch.Tensor,
    node_count: int,
    window: int,
    iterations: int = 10,
    mode: str = "lm",
    init_damping: float = 1e-4,
    anchor_weight: float = 1e6,
) -> Tuple[Pose, SolveStats]:
    """Incremental solve: only the last ``window`` live nodes move,
    conditioned exactly on the frozen prefix (JAX ``optimize_window``).

    ``node_count`` is a host int, so ``start = max(node_count − W, 0)`` is
    one too and the window is a plain slice. The damping is
    ``(λ + 1e-9)·max(scale, 1e-6)`` on each diagonal block; the LM accept
    test compares the cost of the whole graph. The gauge anchor is added
    only when the window starts at node 0; otherwise the frozen prefix
    anchors it through the sequential edge ``(start−1, start)``.
    ``optimize_window.calls`` counts the calls.
    """
    optimize_window.calls += 1
    K = nodes.t.shape[0]
    W = min(window, K)
    start = max(node_count - W, 0)
    dev = nodes.t.device
    local_mask = (torch.arange(W, device=dev) + start < node_count) & node_mask[start : start + W]
    aw = anchor_weight if start == 0 else 0.0

    def step(nds: Pose, lam) -> Pose:
        H, b = _window_normal_equations(nds, edges, start, W, local_mask, aw)
        win = Pose(t=nds.t[start : start + W], q=nds.q[start : start + W])
        new, _ = _solve_and_update(win, H, b, lam + 1e-9, local_mask)
        t, q = nds.t.clone(), nds.q.clone()
        t[start : start + W] = new.t
        q[start : start + W] = new.q
        return Pose(t=t, q=q)

    return _gn_or_lm(step, nodes, edges, iterations, mode, init_damping)


optimize_window.calls = 0
