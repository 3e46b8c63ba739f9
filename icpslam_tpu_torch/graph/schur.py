"""Schur-complement (chunked block elimination) linear solver for the pose
graph (port of ``icpslam_tpu/graph/schur.py``).

The K nodes are cut into contiguous chunks of ``chunk_size``. Each chunk's
interior nodes are eliminated on their own, the reduced system over the
separator nodes (those on a chunk-crossing edge) is solved by one dense
Cholesky, and the interiors are recovered by back-substitution. The
separator set is capped at ``sep_capacity`` slots, filled with the true
separators first (stable sort) and padded with other nodes; keeping a
node that could have been eliminated does not change the solution, so
only ``n_sep > sep_capacity`` is invalid, and ``ok`` reports it. The
eliminated block of each chunk is inverted behind an identity-padded mask,
so every shape is static. JAX's ``vmap`` over the chunks becomes batched
``torch.linalg`` calls.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SchurResult(NamedTuple):
    delta: torch.Tensor  # (K, 6) solution of H x = b
    ok: torch.Tensor     # bool: the separators fit sep_capacity
    n_sep: torch.Tensor  # int32 true separator count


def separator_mask(
    edge_i: torch.Tensor, edge_j: torch.Tensor, edge_valid: torch.Tensor, K: int, chunk_size: int
) -> torch.Tensor:
    """(K,) bool: nodes incident to a valid chunk-crossing edge."""
    cross = (edge_valid & (edge_i // chunk_size != edge_j // chunk_size)).to(torch.int32)
    ei = torch.where(edge_valid, edge_i, 0).long()
    ej = torch.where(edge_valid, edge_j, 0).long()
    m = torch.zeros((K,), dtype=torch.int32, device=edge_i.device)
    return m.index_add_(0, ei, cross).index_add_(0, ej, cross) > 0


def chunk_eliminate(Ac, bc, ec):
    """Eliminate the masked (interior) rows of chunk-diagonal blocks.

    ``Ac``: (..., n, n) chunk matrices, ``bc``: (..., n) right-hand sides,
    ``ec``: (..., n) bool, the eliminated rows. Returns the Schur
    complement onto the kept rows, the reduced right-hand side, and the
    factors back-substitution needs: ``(Sc, bs, Minv, A_es)``.
    """
    e_r, e_c = ec[..., :, None], ec[..., None, :]
    zero = torch.zeros((), dtype=Ac.dtype, device=Ac.device)
    M = torch.where(e_r & e_c, Ac, zero) + torch.diag_embed((~ec).to(Ac.dtype))
    Minv = torch.linalg.inv_ex(M)[0]
    A_se = torch.where(~e_r & e_c, Ac, zero)   # kept rows, eliminated columns
    A_es = torch.where(e_r & ~e_c, Ac, zero)   # eliminated rows, kept columns
    A_ss = torch.where(~e_r & ~e_c, Ac, zero)
    Sc = A_ss - A_se @ (Minv @ A_es)
    be = torch.where(ec, bc, zero)
    bs = torch.where(~ec, bc, zero) - (A_se @ (Minv @ be[..., None]))[..., 0]
    return Sc, bs, Minv, A_es


def back_substitute(Minv_c, A_es_c, bc, ec, ds):
    """The eliminated rows of each chunk, given the kept solution ``ds``
    scattered into the chunk layout (all (..., n) / (..., n, n))."""
    zero = torch.zeros((), dtype=bc.dtype, device=bc.device)
    be = torch.where(ec, bc, zero)
    rhs = be - torch.where(ec, (A_es_c @ ds[..., None])[..., 0], zero)
    return (Minv_c @ rhs[..., None])[..., 0]


def schur_solve(
    H: torch.Tensor,
    b: torch.Tensor,
    sep_mask: torch.Tensor,
    chunk_size: int,
    sep_capacity: int,
) -> SchurResult:
    """Solve H x = b (H: (K, 6, K, 6), regularized and positive definite;
    b: (K, 6)) by chunked block elimination. ``chunk_size`` must divide K;
    ``sep_capacity`` is the static separator budget."""
    K = b.shape[0]
    D = K // chunk_size
    if D * chunk_size != K:
        raise ValueError(f"chunk_size {chunk_size} must divide K={K}")
    S = sep_capacity
    n = 6 * chunk_size
    dev = b.device

    n_sep = sep_mask.sum(dtype=torch.int32)
    ok = n_sep <= S

    # keep-set: the true separators first (stable), padded with other nodes
    order = torch.argsort((~sep_mask).to(torch.int32), stable=True)
    sep_idx = order[:S]
    rank = torch.empty((K,), dtype=torch.int64, device=dev)
    rank[order] = torch.arange(K, device=dev)
    elim = rank >= S

    # chunk-diagonal blocks A_c and the cross part C = H − blockdiag(A)
    H6 = H.reshape(D, chunk_size, 6, D, chunk_size, 6)
    dd = torch.arange(D, device=dev)
    A = H6[dd, :, :, dd, :, :].reshape(D, n, n)
    b_c = b.reshape(D, n)
    elim_c = elim.reshape(D, chunk_size).repeat_interleave(6, dim=1)

    Sc, bs, Minv, A_es = chunk_eliminate(A, b_c, elim_c)

    # reduced system over the keep-set: blockdiag(Sc) + the cross couplings
    # (H with its chunk diagonal zeroed; they touch separators only)
    R_full = H6.clone()
    R_full[dd, :, :, dd, :, :] = Sc.reshape(D, chunk_size, 6, chunk_size, 6)
    R_full = R_full.reshape(K, 6, K, 6)
    R = R_full[sep_idx][:, :, sep_idx, :].reshape(S * 6, S * 6)
    b_red = bs.reshape(K, 6)[sep_idx].reshape(S * 6, 1)
    L, _ = torch.linalg.cholesky_ex(R + 1e-9 * torch.eye(S * 6, dtype=R.dtype, device=dev))
    x_s = torch.cholesky_solve(b_red, L).reshape(S, 6)

    # scatter the kept solution, then back-substitute each chunk's interior
    delta = torch.zeros((K, 6), dtype=b.dtype, device=dev)
    delta[sep_idx] = x_s
    delta_c = delta.reshape(D, n)
    x_e = back_substitute(Minv, A_es, b_c, elim_c, delta_c)
    delta_c = torch.where(elim_c, x_e, delta_c)
    return SchurResult(delta=delta_c.reshape(K, 6), ok=ok, n_sep=n_sep)
