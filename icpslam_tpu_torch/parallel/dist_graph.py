"""Distributed pose-graph Gauss-Newton: edge-sharded assembly over a mesh
(port of ``icpslam_tpu/parallel/dist_graph.py``).

The per-edge residuals, Jacobians and block assembly are sharded by
*edge*: the edge store is padded to a multiple of the shard count D and
cut into D contiguous blocks, and each shard's partial normal equations
are reduced with ``psum`` (``parallel/mesh.py``). The nodes are
replicated. Three linear solvers on top:

- ``direct``: the replicated dense Cholesky of the reduced system;
- ``pcg``: matrix-free CG whose linearisation is local to each shard and
  whose every matvec is a local edge sweep plus one ``psum``;
- ``schur``: node chunks map to shards (chunk ↔ shard); each shard
  eliminates its chunk's interior nodes (``graph/schur.chunk_eliminate``),
  the per-chunk Schur complements are gathered once, the small separator
  system is solved replicated, and back-substitution is local. When the
  separators overflow ``sep_capacity`` the step falls back to the direct
  solve of the same damped system: JAX's ``lax.cond`` on ``ok`` becomes
  one counted host read per step, as in ``pose_graph._schur_step``.

The local shards of a rank are batched: one chain of launches computes
every local edge's terms, and the partial sums carry a leading shard axis
(``pose_graph.edge_contributions(..., shards=)``, the batched
``pose_graph._EndpointSum``); the Schur elimination is batched over the
local chunks.
"""

from __future__ import annotations

from typing import Tuple

import torch

from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.graph import pose_graph as pg
from icpslam_tpu_torch.graph import schur as schur_mod
from icpslam_tpu_torch.parallel.mesh import Mesh, pad_to_multiple, shard_leading
from icpslam_tpu_torch.utils.sync import to_host

# Timing-ablation knob (parallel/scaling.py): True leaves out the
# cross-rank part of every collective (the dist call; the reduction over
# a rank's own shards stays), so a rung timed once normally and once
# ablated splits into {compute_ms, collective_ms}. Numerically wrong by
# construction when the mesh spans ranks; never enable outside the
# scaling harness.
ABLATE_COLLECTIVES = False


def _shardable_edges(edges: pg.EdgeSet, n_shards: int) -> pg.EdgeSet:
    """The edge arrays padded so that the capacity divides the shard count;
    padding rows are invalid, with the identity ``rel_q``, and add zero."""
    E = edges.capacity
    pad = pad_to_multiple(E, n_shards) - E
    if pad == 0:
        return edges
    dev = edges.i.device
    q_pad = torch.zeros((pad, 4), dtype=edges.rel_q.dtype, device=dev)
    q_pad[:, 0] = 1.0
    return pg.EdgeSet(
        i=torch.cat([edges.i, edges.i.new_zeros(pad)]),
        j=torch.cat([edges.j, edges.j.new_zeros(pad)]),
        rel_t=torch.cat([edges.rel_t, edges.rel_t.new_zeros((pad, 3))]),
        rel_q=torch.cat([edges.rel_q, q_pad]),
        info=torch.cat([edges.info, edges.info.new_zeros((pad, 6, 6))]),
        valid=torch.cat([edges.valid, edges.valid.new_zeros(pad)]),
        count=edges.count,
        overflow=edges.overflow,
    )


def _local_edges(edges: pg.EdgeSet, mesh: Mesh) -> pg.EdgeSet:
    """This rank's ``local`` edge shards, contiguous, flat."""
    ep = _shardable_edges(edges, mesh.size)
    return pg.EdgeSet(*(shard_leading(mesh, x) if x.dim() else x for x in ep))


def sharded_edge_contributions(nodes: Pose, edges: pg.EdgeSet, mesh: Mesh
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, 6, K, 6) H and (K, 6) b assembled from the shards' edges and
    reduced over the mesh."""
    H, b = pg.edge_contributions(nodes, _local_edges(edges, mesh), shards=mesh.local)
    return mesh.psum(H), mesh.psum(b)


def _sharded_pcg_delta(nodes: Pose, edges: pg.EdgeSet, node_mask, damping, mesh: Mesh,
                       anchor_weight: float = 1e6, cg_iterations: int = 50) -> torch.Tensor:
    """The (K, 6) step of one GN/LM iteration by distributed matrix-free
    PCG: each shard linearizes its edges once; every CG matvec is a local
    edge sweep and one ``psum``. No (6K)² matrix anywhere."""
    K = nodes.t.shape[0]
    loc = _local_edges(edges, mesh)

    def by_shard(x):
        return x.reshape((mesh.local, -1) + tuple(x.shape[1:]))

    r, Ji, Jj, info = (by_shard(x) for x in pg._edge_linearization(nodes, loc))
    at = pg._EndpointSum(by_shard(loc.i.long()), by_shard(loc.j.long()), K, info.dtype)
    b = mesh.psum(pg._edge_gradient(r, Ji, Jj, info, at)) * node_mask[:, None]
    D = pg._regularize_diag(mesh.psum(pg._edge_diag_blocks(Ji, Jj, info, at)), node_mask,
                            anchor_weight)
    scale = torch.diagonal(D, dim1=-2, dim2=-1).sum(-1) / 6.0
    damping_diag = (damping * torch.clamp(scale, min=1e-6))[:, None]
    eye6 = torch.eye(6, dtype=D.dtype, device=D.device)
    Dinv = torch.linalg.inv_ex(D + damping_diag[..., None] * eye6 + 1e-9 * eye6)[0]

    def apply_fn(x):
        y = mesh.psum(pg._apply_H_edges(Ji, Jj, info, at, x))
        return pg._regularize_apply(y, x, node_mask, anchor_weight, damping_diag)

    delta, _ = pg.pcg_solve(apply_fn, Dinv, -b, iterations=cg_iterations)
    return delta


def _check_chunks(K: int, mesh: Mesh) -> int:
    if K % mesh.size:
        raise ValueError(f"node capacity {K} must divide the mesh axis {mesh.size}")
    return K // mesh.size


def _sharded_schur_delta(
    Hd: torch.Tensor,        # (K, 6, K, 6) regularized and damped, positive definite
    b: torch.Tensor,         # (K, 6) right-hand side
    sep_mask: torch.Tensor,  # (K,) bool from schur.separator_mask
    mesh: Mesh,
    sep_capacity: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed Schur solve of ``Hd x = b``, chunk ↔ shard. Returns
    ``(delta (K, 6), ok)``; ``ok`` is False iff the true separator count
    exceeds ``sep_capacity``."""
    K = b.shape[0]
    D = mesh.size
    chunk = _check_chunks(K, mesh)
    n = 6 * chunk
    S = min(sep_capacity, K)  # a separator set never exceeds the node count
    dev = b.device

    n_sep = sep_mask.sum(dtype=torch.int32)
    ok = n_sep <= S
    order = torch.argsort((~sep_mask).to(torch.int32), stable=True)
    sep_idx = order[:S]
    rank = torch.empty((K,), dtype=torch.int64, device=dev)
    rank[order] = torch.arange(K, device=dev)
    elim = rank >= S

    H6 = Hd.reshape(D, chunk, 6, D, chunk, 6)
    dd = torch.arange(D, device=dev)
    A = H6[dd, :, :, dd, :, :].reshape(D, n, n)
    b_c = b.reshape(D, n)
    elim_c = elim.reshape(D, chunk).repeat_interleave(6, dim=1)

    # replicated small pieces: the separators' cross couplings
    cross = H6.clone()
    cross[dd, :, :, dd, :, :] = 0.0
    R_cross = cross.reshape(K, 6, K, 6)[sep_idx][:, :, sep_idx, :]   # (S, 6, S, 6)
    sep_chunk = sep_idx // chunk
    sep_within = sep_idx % chunk

    # local interior elimination of this rank's chunks, one gather of the
    # per-chunk Schur contributions
    lo, hi = mesh.first, mesh.first + mesh.local
    A_l, b_l, e_l = A[lo:hi], b_c[lo:hi], elim_c[lo:hi]
    Sc, bs, Minv, A_es = schur_mod.chunk_eliminate(A_l, b_l, e_l)
    Sc_all = mesh.all_gather_tiled(Sc)                                # (D, n, n)
    bs_all = mesh.all_gather_tiled(bs)                                # (D, n)

    # the replicated separator system: blockdiag(Sc) on the keep-set plus
    # the cross couplings
    Sc6 = Sc_all.reshape(D, chunk, 6, chunk, 6)
    bd = Sc6[sep_chunk[:, None], sep_within[:, None], :, sep_within[None, :], :]  # (S, S, 6, 6)
    same = sep_chunk[:, None] == sep_chunk[None, :]
    bd = torch.where(same[:, :, None, None], bd, 0.0)
    R = (bd.transpose(1, 2) + R_cross).reshape(S * 6, S * 6)
    b_red = bs_all.reshape(K, 6)[sep_idx].reshape(S * 6, 1)
    L, _ = torch.linalg.cholesky_ex(R + 1e-9 * torch.eye(S * 6, dtype=R.dtype, device=dev))
    x_s = torch.cholesky_solve(b_red, L).reshape(S, 6)

    # local back-substitution on this rank's chunks, then one gather
    delta_full = torch.zeros((K, 6), dtype=b.dtype, device=dev)
    delta_full[sep_idx] = x_s
    delta_c = delta_full.reshape(D, n)[lo:hi]
    x_e = schur_mod.back_substitute(Minv, A_es, b_l, e_l, delta_c)
    delta = mesh.all_gather_tiled(torch.where(e_l, x_e, delta_c))
    return delta.reshape(K, 6), ok


def _sharded_schur_step(nodes: Pose, edges: pg.EdgeSet, node_mask, damping, mesh: Mesh,
                        sep_capacity: int = 64) -> Pose:
    """One GN/LM step: edge-sharded assembly and the distributed Schur
    solve, or the replicated direct solve of the same damped system when
    the separators overflow (``ok`` read on the host)."""
    K = nodes.t.shape[0]
    chunk = _check_chunks(K, mesh)
    H, b = sharded_edge_contributions(nodes, edges, mesh)
    H, b = pg.regularize_normal_equations(H, b, node_mask)
    Hd = pg._damped(H, damping)
    sm = schur_mod.separator_mask(edges.i, edges.j, edges.valid, K, chunk)
    delta, ok = _sharded_schur_delta(Hd, -b, sm, mesh, sep_capacity=sep_capacity)
    if not bool(to_host(ok)):
        delta = pg._cholesky_delta(Hd, b)
    return pg._apply_delta(nodes, delta, node_mask)


def optimize(
    nodes: Pose,
    edges: pg.EdgeSet,
    node_mask: torch.Tensor,
    mesh: Mesh,
    iterations: int = 10,
    mode: str = "lm",
    init_damping: float = 1e-4,
    linear_solver: str = "direct",
    cg_iterations: int = 50,
    sep_capacity: int = 64,
) -> Tuple[Pose, pg.SolveStats]:
    """Distributed drop-in for ``pose_graph.optimize``: ``'direct'``,
    ``'pcg'``, ``'schur'``, or ``'auto'`` (direct up to 256 nodes, PCG
    above, as ``pose_graph.optimize``). GN or LM as there; the LM accept
    test compares the replicated graph cost. ``optimize.calls`` counts the
    eager calls, ``optimize.replays`` the replays of a captured one
    (``graph/captured.py``)."""
    optimize.calls += 1
    solver = pg.resolve_linear_solver(linear_solver, nodes.t.shape[0])
    if solver == "pcg":
        def step(nds, lam):
            delta = _sharded_pcg_delta(nds, edges, node_mask, lam, mesh,
                                       cg_iterations=cg_iterations)
            return pg._apply_delta(nds, delta, node_mask)
    elif solver == "schur":
        def step(nds, lam):
            return _sharded_schur_step(nds, edges, node_mask, lam, mesh, sep_capacity)
    elif solver == "direct":
        def step(nds, lam):
            H, b = sharded_edge_contributions(nds, edges, mesh)
            H, b = pg.regularize_normal_equations(H, b, node_mask)
            return pg._solve_and_update(nds, H, b, lam, node_mask)
    else:
        raise ValueError(f"linear_solver={linear_solver!r}: expected 'direct', 'pcg', 'schur' "
                         "or 'auto'")
    return pg._gn_or_lm(step, nodes, edges, iterations, mode, init_damping)


optimize.calls = 0
optimize.replays = 0
