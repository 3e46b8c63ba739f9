"""SE(3) pose-graph optimization (port of ``icpslam_tpu/graph/pose_graph.py``).

Edge residuals ``log(Z⁻¹ X_i⁻¹ X_j)`` with closed-form right-perturbation
Jacobians, dense block normal equations assembled with ``index_put_``
accumulation (sorted, so deterministic on the card) and the other node
sums by :class:`_EndpointSum` (no atomics on the card), the node-0 gauge
anchor, and GN / LM with three linear
solvers: a dense Cholesky (``torch.linalg.cholesky_ex``, no host check),
matrix-free block-Jacobi PCG with its CG loop kept on the device, and the
chunked Schur elimination of ``graph/schur.py``. :func:`optimize_bucketed`
resolves ``'auto'`` on JAX's bucket and solves every solver at the bucket
size (:func:`solve_bucket`). :func:`optimize_window` is the incremental
solve of the trailing window, conditioned on the frozen prefix, with its
start on the device. Both have static shapes and make no host-to-device
copy, so ``graph/captured.py`` can capture them as CUDA graphs.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from icpslam_tpu_torch.geometry import se3
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.graph import schur as schur_mod
from icpslam_tpu_torch.utils.sync import to_host


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


class _EndpointSum:
    """Sums of per-edge rows onto the edges' endpoints: ``s(a, b)[k] =
    Σ_{e: i_e = k} a[e] + Σ_{e: j_e = k} b[e]`` over ``n`` nodes. With
    ``ei``, ``ej`` of shape (L, E), L edge sets are summed apart, each onto
    its own ``n`` nodes (the local shards of ``parallel/dist_graph.py``):
    ``a``, ``b`` are (L, E, ...) and the sums (L, n, ...).

    On the card the sums are products with the (n, E) incidence matrices,
    in a fixed order and without atomics, so a solve gives the same bits
    in every run, eager or replayed from a CUDA graph (``index_add_``
    sums there with atomics, in an order that changes from run to run).
    On the CPU they are ``index_add_``, serial in edge order.
    """

    def __init__(self, ei: torch.Tensor, ej: torch.Tensor, n: int, dtype):
        self.ei, self.ej, self.n = ei, ej, n
        if ei.is_cuda:
            nodes = torch.arange(n, device=ei.device)[:, None]
            self.Mi = (ei[..., None, :] == nodes).to(dtype)
            self.Mj = (ej[..., None, :] == nodes).to(dtype)

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        lead = tuple(self.ei.shape[:-1])
        E = self.ei.shape[-1]
        rest = tuple(a.shape[len(lead) + 1:])
        shape = lead + (self.n,) + rest
        if self.ei.is_cuda:
            return (self.Mi @ a.reshape(lead + (E, -1))
                    + self.Mj @ b.reshape(lead + (E, -1))).reshape(shape)
        if not lead:
            return a.new_zeros(shape).index_add_(0, self.ei, a).index_add_(0, self.ej, b)
        off = torch.arange(lead[0], device=a.device)[:, None] * self.n
        flat = a.new_zeros((lead[0] * self.n,) + rest)
        flat.index_add_(0, (self.ei + off).reshape(-1), a.reshape((-1,) + rest))
        flat.index_add_(0, (self.ej + off).reshape(-1), b.reshape((-1,) + rest))
        return flat.reshape(shape)


def edge_contributions(nodes: Pose, edges: EdgeSet, shards: int | None = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The edges' part of the normal equations: (K, 6, K, 6) H and (K, 6) b
    (invalid edges add zero). With ``shards``, the E edges are that many
    contiguous blocks, summed apart: (shards, K, 6, K, 6) and (shards, K,
    6), the partial sums that ``parallel/dist_graph.py`` reduces."""
    K = nodes.t.shape[0]
    dt, dev = nodes.t.dtype, nodes.t.device
    r, Ji, Jj = _edge_jacobians(nodes, edges)
    info = edges.info * edges.valid.to(dt)[:, None, None]
    JiT_O = Ji.mT @ info
    JjT_O = Jj.mT @ info
    Hii, Hij, Hjj = JiT_O @ Ji, JiT_O @ Jj, JjT_O @ Jj
    ei, ej = edges.i.long(), edges.j.long()
    lead, sid, at_i, at_j = (), (), ei, ej
    if shards is not None:
        E = ei.shape[0]
        lead, sid = (shards,), (torch.arange(E, device=dev) // (E // shards),)
        at_i, at_j = ei.reshape(shards, -1), ej.reshape(shards, -1)
    H = torch.zeros(lead + (K, K, 6, 6), dtype=dt, device=dev)
    H.index_put_(sid + (ei, ei), Hii, accumulate=True)
    H.index_put_(sid + (ei, ej), Hij, accumulate=True)
    H.index_put_(sid + (ej, ei), Hij.mT, accumulate=True)
    H.index_put_(sid + (ej, ej), Hjj, accumulate=True)
    bi = (JiT_O @ r[..., None])[..., 0].reshape(lead + (-1, 6))
    bj = (JjT_O @ r[..., None])[..., 0].reshape(lead + (-1, 6))
    b = _EndpointSum(at_i, at_j, K, dt)(bi, bj)
    return H.transpose(-3, -2), b


def regularize_normal_equations(
    H: torch.Tensor, b: torch.Tensor, node_mask: torch.Tensor, anchor_weight: float = 1e6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dead nodes on an identity diagonal with a zero gradient, and node 0
    anchored (gauge fix); ``H`` (K, 6, K, 6) is updated in place."""
    K = b.shape[0]
    eye6 = torch.eye(6, dtype=H.dtype, device=H.device)
    diag = torch.arange(K, device=H.device)
    H[diag, :, diag, :] += (~node_mask).to(H.dtype)[:, None, None] * eye6
    H[0, :, 0, :] += anchor_weight * eye6
    return H, b * node_mask[:, None]


def normal_equations(
    nodes: Pose, edges: EdgeSet, node_mask: torch.Tensor, anchor_weight: float = 1e6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, 6, K, 6) H and (K, 6) b, with dead nodes on an identity diagonal
    and node 0 anchored (gauge fix)."""
    H, b = edge_contributions(nodes, edges)
    return regularize_normal_equations(H, b, node_mask, anchor_weight)


def _damped(H: torch.Tensor, damping) -> torch.Tensor:
    """``H`` with ``damping·max(mean diagonal, 1e-6)`` added to each node's
    diagonal block; ``damping`` may be a 0-d tensor."""
    K = H.shape[0]
    eye6 = torch.eye(6, dtype=H.dtype, device=H.device)
    diag = torch.arange(K, device=H.device)
    blocks = H[diag, :, diag, :]
    scale = torch.diagonal(blocks, dim1=-2, dim2=-1).sum(-1) / 6.0
    Hd = H.clone()
    Hd[diag, :, diag, :] = blocks + (damping * torch.clamp(scale, min=1e-6))[:, None, None] * eye6
    return Hd


def _cholesky_delta(Hd: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(K, 6) solution of ``Hd x = −b`` by a dense Cholesky."""
    K = b.shape[0]
    L, _ = torch.linalg.cholesky_ex(Hd.reshape(K * 6, K * 6))
    return torch.cholesky_solve(-b.reshape(K * 6, 1), L).reshape(K, 6)


def _apply_delta(nodes: Pose, delta: torch.Tensor, node_mask: torch.Tensor) -> Pose:
    delta = delta * node_mask[:, None]
    return se3.normalize(se3.compose(nodes, se3.se3_exp(delta)))


def _solve_and_update(nodes: Pose, H: torch.Tensor, b: torch.Tensor, damping, node_mask) -> Pose:
    """Damped dense Cholesky step; ``damping`` may be a 0-d tensor."""
    return _apply_delta(nodes, _cholesky_delta(_damped(H, damping), b), node_mask)


# ---------------------------------------------------------------------------
# Matrix-free PCG (JAX pose_graph.py:233-364)
# ---------------------------------------------------------------------------


def _edge_linearization(nodes: Pose, edges: EdgeSet):
    """Per-edge residuals and Jacobians and the masked information, made
    once per outer iteration and reused by every CG matvec."""
    r, Ji, Jj = _edge_jacobians(nodes, edges)
    info = edges.info * edges.valid.to(nodes.t.dtype)[:, None, None]
    return r, Ji, Jj, info


def _edge_diag_blocks(Ji, Jj, info, at: _EndpointSum) -> torch.Tensor:
    """The edges' part of H's block diagonal, (K, 6, 6)."""
    return at(Ji.mT @ info @ Ji, Jj.mT @ info @ Jj)


def _regularize_diag(D, node_mask, anchor_weight):
    eye6 = torch.eye(6, dtype=D.dtype, device=D.device)
    D = D + (~node_mask).to(D.dtype)[:, None, None] * eye6
    D[0] += anchor_weight * eye6
    return D


def _diag_blocks(Ji, Jj, info, at: _EndpointSum, node_mask, anchor_weight):
    """Block diagonal of the regularized H: the Jacobi preconditioner."""
    return _regularize_diag(_edge_diag_blocks(Ji, Jj, info, at), node_mask, anchor_weight)


def _edge_gradient(r, Ji, Jj, info, at: _EndpointSum) -> torch.Tensor:
    """b = Σ JᵀΩr over the edges, (K, 6)."""
    v = info @ r[..., None]
    return at((Ji.mT @ v)[..., 0], (Jj.mT @ v)[..., 0])


def _apply_H_edges(Ji, Jj, info, at: _EndpointSum, x):
    """The edges' part of H @ x."""
    u = Ji @ x[at.ei][..., None] + Jj @ x[at.ej][..., None]
    v = info @ u
    return at((Ji.mT @ v)[..., 0], (Jj.mT @ v)[..., 0])


def _regularize_apply(y, x, node_mask, anchor_weight, damping_diag):
    y = y + (~node_mask).to(x.dtype)[:, None] * x
    y[0] += anchor_weight * x[0]
    return y + damping_diag * x


def _apply_H(Ji, Jj, info, at: _EndpointSum, x, node_mask, anchor_weight, damping_diag):
    """y = (H_reg + diagonal damping) @ x without forming H; x, y: (K, 6)."""
    y = _apply_H_edges(Ji, Jj, info, at, x)
    return _regularize_apply(y, x, node_mask, anchor_weight, damping_diag)


def pcg_solve(apply_fn, Dinv, b, iterations: int = 50, tol: float = 1e-8):
    """Preconditioned conjugate gradients for H x = b, ``apply_fn(x) = H @ x``,
    ``Dinv`` the (K, 6, 6) block-Jacobi inverse. Returns ``(x, steps)``.

    JAX's ``while_loop`` stops once ``r·r <= tol²·b²``. Here all
    ``iterations`` steps are dispatched and ``x, r, p, rz`` freeze with
    ``torch.where`` from the first step where that holds, which gives the
    early exit's result with no host read per step.
    """
    def precond(r):
        return (Dinv @ r[..., None])[..., 0]

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = (r * z).sum()
    thresh = tol * tol * torch.clamp((b * b).sum(), min=1e-30)
    live = torch.ones((), dtype=torch.bool, device=b.device)
    steps = torch.zeros((), dtype=torch.int32, device=b.device)
    tiny = torch.full((), 1e-30, dtype=b.dtype, device=b.device)
    for _ in range(iterations):
        live = live & ((r * r).sum() > thresh)
        Ap = apply_fn(p)
        denom = (p * Ap).sum()
        alpha = rz / torch.where(denom.abs() < 1e-30, tiny, denom)
        r_new = r - alpha * Ap
        z = precond(r_new)
        rz_new = (r_new * z).sum()
        beta = rz_new / torch.where(rz.abs() < 1e-30, tiny, rz)
        x = torch.where(live, x + alpha * p, x)
        p = torch.where(live, z + beta * p, p)
        r = torch.where(live, r_new, r)
        rz = torch.where(live, rz_new, rz)
        steps = steps + live.to(torch.int32)
    return x, steps


def _pcg_delta(nodes: Pose, edges: EdgeSet, node_mask, damping, anchor_weight=1e6,
               cg_iterations: int = 50) -> torch.Tensor:
    """The (K, 6) step of one GN/LM iteration by matrix-free PCG."""
    K = nodes.t.shape[0]
    ei, ej = edges.i.long(), edges.j.long()
    r, Ji, Jj, info = _edge_linearization(nodes, edges)
    at = _EndpointSum(ei, ej, K, info.dtype)
    b = _edge_gradient(r, Ji, Jj, info, at) * node_mask[:, None]
    D = _diag_blocks(Ji, Jj, info, at, node_mask, anchor_weight)
    scale = torch.diagonal(D, dim1=-2, dim2=-1).sum(-1) / 6.0
    damping_diag = (damping * torch.clamp(scale, min=1e-6))[:, None]
    eye6 = torch.eye(6, dtype=D.dtype, device=D.device)
    Dinv = torch.linalg.inv_ex(D + damping_diag[..., None] * eye6 + 1e-9 * eye6)[0]

    def apply_fn(x):
        return _apply_H(Ji, Jj, info, at, x, node_mask, anchor_weight, damping_diag)

    delta, _ = pcg_solve(apply_fn, Dinv, -b, iterations=cg_iterations)
    return delta


def _pcg_step(nodes: Pose, edges: EdgeSet, node_mask, damping, anchor_weight=1e6,
              cg_iterations: int = 50) -> Pose:
    """One GN/LM step with the matrix-free PCG linear solver."""
    delta = _pcg_delta(nodes, edges, node_mask, damping, anchor_weight, cg_iterations)
    return _apply_delta(nodes, delta, node_mask)


def _schur_step(nodes: Pose, edges: EdgeSet, node_mask, damping, chunk_size: int,
                sep_capacity: int) -> Pose:
    """One GN/LM step by chunked Schur elimination of the damped system,
    or, where the separators overflow ``sep_capacity``, by the dense
    Cholesky of the same system. ``ok`` is read on the host (one counted
    read per step): JAX's ``lax.cond`` on it becomes a host branch."""
    K = nodes.t.shape[0]
    H, b = normal_equations(nodes, edges, node_mask)
    Hd = _damped(H, damping)
    sm = schur_mod.separator_mask(edges.i, edges.j, edges.valid, K, chunk_size)
    res = schur_mod.schur_solve(Hd, -b, sm, chunk_size, sep_capacity)
    delta = res.delta if bool(to_host(res.ok)) else _cholesky_delta(Hd, b)
    return _apply_delta(nodes, delta, node_mask)


def resolve_linear_solver(linear_solver: str, n_nodes: int) -> str:
    """'auto' is the dense Cholesky up to 256 nodes and PCG above (JAX's
    rule, kept for parity); any other name is returned as it is."""
    if linear_solver == "auto":
        return "direct" if n_nodes <= 256 else "pcg"
    return linear_solver


def optimize(
    nodes: Pose,
    edges: EdgeSet,
    node_mask: torch.Tensor,
    iterations: int = 10,
    mode: str = "lm",
    init_damping: float = 1e-4,
    linear_solver: str = "direct",
    cg_iterations: int = 50,
    schur_chunk_size: int = 64,
    schur_sep_capacity: int = 64,
) -> Tuple[Pose, SolveStats]:
    """GN (fixed steps) or LM (accept/reject with adaptive damping, kept on
    the device with ``torch.where``). ``linear_solver``: 'direct' (dense
    block Cholesky), 'pcg' (matrix-free block-Jacobi PCG, ``cg_iterations``
    steps at most), 'schur' (chunked elimination, ``graph/schur.py``,
    falling back to the dense Cholesky of the same damped system when the
    separators overflow) or 'auto' (direct up to 256 nodes, PCG above).
    ``optimize.pcg_solves`` counts the calls that solve by PCG."""
    solver = resolve_linear_solver(linear_solver, nodes.t.shape[0])
    if solver == "pcg":
        optimize.pcg_solves += 1

        def step(nds, lam):
            return _pcg_step(nds, edges, node_mask, lam, cg_iterations=cg_iterations)
    elif solver == "schur":
        def step(nds, lam):
            return _schur_step(nds, edges, node_mask, lam, schur_chunk_size, schur_sep_capacity)
    elif solver == "direct":
        def step(nds, lam):
            H, b = normal_equations(nds, edges, node_mask)
            return _solve_and_update(nds, H, b, lam, node_mask)
    else:
        raise ValueError(f"linear_solver={linear_solver!r}: expected 'direct', 'pcg', 'schur' "
                         "or 'auto' (the dist-* solvers are parallel/dist_graph.optimize)")

    return _gn_or_lm(step, nodes, edges, iterations, mode, init_damping)


optimize.pcg_solves = 0


def _gn_or_lm(step, nodes: Pose, edges: EdgeSet, iterations: int, mode: str, init_damping: float):
    """``iterations`` fixed GN steps (``step(nodes, 0.0)``) or LM steps that
    are kept only when they lower the graph's cost, the damping halved on
    accept and quadrupled on reject — all on the device, with no host read
    and no host-to-device copy."""
    dev = nodes.t.device
    c0 = graph_cost(nodes, edges)
    its = torch.full((), iterations, dtype=torch.int32, device=dev)
    if mode == "gn":
        for _ in range(iterations):
            nodes = step(nodes, 0.0)
        return nodes, SolveStats(c0, graph_cost(nodes, edges), its)

    lam = torch.full((), init_damping, dtype=nodes.t.dtype, device=dev)
    cost = c0
    for _ in range(iterations):
        cand = step(nodes, lam)
        c_new = graph_cost(cand, edges)
        accept = c_new < cost
        nodes = se3.where(accept, cand, nodes)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9), torch.clamp(lam * 4.0, max=1e6))
        cost = torch.where(accept, c_new, cost)
    return nodes, SolveStats(c0, cost, its)


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
    optimize_fn=None,
    **kw,
) -> Tuple[Pose, SolveStats]:
    """Solve the live graph (``node_count`` nodes, ``edge_count`` edges —
    host ints; the stores are prefix-filled) on JAX's bucket
    (:func:`bucket_size`), with ``linear_solver`` resolved there: 'auto'
    is direct up to a 256-node bucket and PCG above. ``optimize_fn``
    (default :func:`optimize`) solves the bucket; the streaming step
    passes ``parallel/dist_graph.optimize`` with the mesh bound."""
    K, E = nodes.t.shape[0], edges.i.shape[0]
    bucket = bucket_size(node_count, edge_count, K, E, min_bucket)
    return solve_bucket(
        nodes, edges, node_mask, bucket, resolve_linear_solver(linear_solver, bucket),
        optimize_fn=optimize_fn, **kw,
    )


def solve_bucket(
    nodes: Pose,
    edges: EdgeSet,
    node_mask: torch.Tensor,
    bucket: int,
    linear_solver: str,
    optimize_fn=None,
    **kw,
) -> Tuple[Pose, SolveStats]:
    """:func:`optimize` (or ``optimize_fn``) on the prefix of ``bucket`` nodes and ``E·bucket/K``
    edges, as JAX's ``optimize_bucketed`` branch solves it; the shapes
    depend on the bucket alone.

    The dead nodes and invalid edges of the prefix add decoupled identity
    blocks and zero residuals, so the poses are those of a solve at the
    live size. Invalid edges past the count may hold stale indices beyond
    the bucket (a CUDA gather out of range would abort the context); they
    add exact zeros, so they are spread over the bucket's nodes (edge e
    on node e mod bucket), which keeps the card's sorted accumulation
    from queueing them all on one node.
    """
    K, E = nodes.t.shape[0], edges.i.shape[0]
    n, eb = bucket, max(1, (E * bucket) // K)
    valid = edges.valid[:eb]
    spread = (torch.arange(eb, device=valid.device) % n).to(edges.i.dtype)
    sub = EdgeSet(
        i=torch.where(valid, edges.i[:eb], spread), j=torch.where(valid, edges.j[:eb], spread),
        rel_t=edges.rel_t[:eb], rel_q=edges.rel_q[:eb], info=edges.info[:eb], valid=valid,
        count=torch.clamp(edges.count, max=eb), overflow=edges.overflow,
    )
    opt, stats = (optimize_fn or optimize)(
        Pose(t=nodes.t[:n], q=nodes.q[:n]), sub, node_mask[:n], linear_solver=linear_solver, **kw,
    )
    full = Pose(t=nodes.t.clone(), q=nodes.q.clone())
    full.t[:n] = opt.t
    full.q[:n] = opt.q
    return full, stats


def _window_normal_equations(
    nodes: Pose,
    edges: EdgeSet,
    start: torch.Tensor,
    window: int,
    local_mask: torch.Tensor,
    anchor_weight: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W, 6, W, 6) H and (W, 6) b of the window ``[start, start+W)``
    (``start`` a 0-d device tensor).

    Exact conditioning on the frozen prefix: an edge endpoint outside the
    window has its Jacobian zeroed, which removes its rows and columns
    from H while its residual stays evaluated at the frozen pose — an
    edge into the prefix becomes a unary prior on its in-window endpoint.
    An endpoint outside the window has a zero Jacobian, and an invalid edge
    zero information, so what they add is zero wherever it lands: edge e's
    lands on window node e mod W, which keeps the card's sorted
    accumulation from queueing every such edge on one node. The gauge
    anchor goes on window node 0 with ``anchor_weight`` (0 unless
    ``start == 0``).
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
    spread = torch.arange(ei.shape[0], device=dev) % W
    ci = torch.where((in_i > 0) & edges.valid, ei - start, spread)
    cj = torch.where((in_j > 0) & edges.valid, ej - start, spread)
    JiT_O = Ji.mT @ info
    JjT_O = Jj.mT @ info
    Hii, Hij, Hjj = JiT_O @ Ji, JiT_O @ Jj, JjT_O @ Jj
    H = torch.zeros((W, W, 6, 6), dtype=dt, device=dev)
    H.index_put_((ci, ci), Hii, accumulate=True)
    H.index_put_((ci, cj), Hij, accumulate=True)
    H.index_put_((cj, ci), Hij.mT, accumulate=True)
    H.index_put_((cj, cj), Hjj, accumulate=True)
    b = _EndpointSum(ci, cj, W, dt)((JiT_O @ r[..., None])[..., 0], (JjT_O @ r[..., None])[..., 0])
    eye6 = torch.eye(6, dtype=dt, device=dev)
    diag = torch.arange(W, device=dev)
    H[diag, diag] += (~local_mask).to(dt)[:, None, None] * eye6
    b = b * local_mask[:, None]
    H[0, 0] += anchor_weight * eye6
    return H.permute(0, 2, 1, 3), b


def optimize_window(
    nodes: Pose,
    edges: EdgeSet,
    node_mask: torch.Tensor,
    node_count,
    window: int,
    iterations: int = 10,
    mode: str = "lm",
    init_damping: float = 1e-4,
    anchor_weight: float = 1e6,
) -> Tuple[Pose, SolveStats]:
    """Incremental solve: only the last ``window`` live nodes move,
    conditioned exactly on the frozen prefix (JAX ``optimize_window``).

    ``node_count`` is a 0-d int device tensor (a host int is put on the
    device), so ``start = max(node_count − W, 0)`` stays there and the
    window is gathered and scattered through ``start + arange(W)``; the
    edges are the whole store with its valid mask. The shapes depend on W,
    K and E alone. The damping is ``(λ + 1e-9)·max(scale, 1e-6)`` on each
    diagonal block; the LM accept test compares the cost of the whole
    graph. The gauge anchor is added only when the window starts at node
    0; otherwise the frozen prefix anchors it through the sequential edge
    ``(start−1, start)``. ``optimize_window.calls`` counts the calls.
    """
    optimize_window.calls += 1
    K = nodes.t.shape[0]
    W = min(window, K)
    dt, dev = nodes.t.dtype, nodes.t.device
    if not isinstance(node_count, torch.Tensor):
        node_count = torch.full((), node_count, dtype=torch.int32, device=dev)
    start = torch.clamp(node_count.long() - W, min=0)
    ids = start + torch.arange(W, device=dev)
    local_mask = (ids < node_count) & node_mask[ids]
    aw = (start == 0).to(dt) * anchor_weight

    def step(nds: Pose, lam) -> Pose:
        H, b = _window_normal_equations(nds, edges, start, W, local_mask, aw)
        win = Pose(t=nds.t[ids], q=nds.q[ids])
        new = _solve_and_update(win, H, b, lam + 1e-9, local_mask)
        return Pose(t=nds.t.index_copy(0, ids, new.t), q=nds.q.index_copy(0, ids, new.q))

    return _gn_or_lm(step, nodes, edges, iterations, mode, init_damping)


optimize_window.calls = 0
