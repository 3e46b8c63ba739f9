"""Skew-aware registration for in-loop motion de-skew (port of ``icpslam_tpu/ops/skew_icp.py``).

Two Gauss-Newton solvers over skewed lidar sweeps, each point carrying its
capture-time fraction ``u`` (``cloud/deskew.py``):

- :func:`coupled_deskew_icp` warps the skewed TARGET by the transform
  being solved (the previous sweep's smear is the motion this
  registration measures) and the source by the same transform under
  constant velocity, or by a freed source twist (12 unknowns) tied to it
  by a relative prior; the pose information it returns is the Schur
  complement of that twist block.
- :func:`skew_aware_icp` (the ``joint`` mode) solves pose and sweep twist
  against a clean target, with a stiff prior on the twist's translation.

The JAX ``lax.while_loop`` becomes the idiom of ``ops/icp.py``: a Python
loop whose per-point work (warps, the 1-NN kernel K1 on the re-warped
target, residuals, Jacobians and the reduction to H and g) runs on the
tensors' device, and one counted host read per iteration brings H, g and
the few scalars the host needs. The (6×6 or 12×12) solve, the prior, the
``relaxed`` latch of the auto prior and the stopping test run on the
host in float32, like the 6×6 solve of ``ops/icp.py``. The target
changes every iteration, so K1 stages it afresh on every call.

K1 is exact here: JAX's ``prune_beyond`` cap is ignored (``ops/nn.py``),
and every match beyond ``max_correspondence_distance`` is gated out of
``corr`` again below, so the correspondences are JAX's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from icpslam_tpu_torch.cloud.deskew import deskew_points
from icpslam_tpu_torch.cloud.pointcloud import PointCloud
from icpslam_tpu_torch.geometry import quaternion as quat
from icpslam_tpu_torch.geometry import se3
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.ops import nn as nn_ops
from icpslam_tpu_torch.ops.icp import MIN_CORRESPONDENCES, _huber_weights
from icpslam_tpu_torch.ops.linalg3 import inv_sym3_comps, rotate_sym3_comps
from icpslam_tpu_torch.utils import profiling
from icpslam_tpu_torch.utils.sync import to_host


class SkewIcpResult(NamedTuple):
    pose: Pose                # sweep-START pose of the source in the target frame
    skew_twist: torch.Tensor  # (6,) [t_m | ω_m] motion across the source sweep
    fitness: torch.Tensor
    converged: torch.Tensor
    num_correspondences: torch.Tensor
    iterations: torch.Tensor
    hessian: Optional[torch.Tensor] = None  # (6, 6) pose information


def _basis(p: torch.Tensor) -> torch.Tensor:
    """(N, 3, 6) ``[I | −skew(p)]``."""
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape[0], 3, 3)
    return torch.cat([eye, -se3.skew(p)], dim=-1)


def _information(plane, R, source_covs, target_covs, idx, n, ref) -> torch.Tensor:
    """(N, 3, 3) per-point weighting: ``(C_dst + R C_src Rᵀ)⁻¹`` in plane
    mode, the identity otherwise."""
    if not plane:
        return torch.eye(3, dtype=ref.dtype, device=ref.device).expand(n, 3, 3)
    ba, bb, bc, bd, be, bf = rotate_sym3_comps(R, tuple(source_covs.unbind(0)))
    tg = target_covs[:, idx]
    Wa, Wb, Wc, Wd, We, Wf = inv_sym3_comps(
        tg[0] + ba, tg[1] + bb, tg[2] + bc, tg[3] + bd, tg[4] + be, tg[5] + bf
    )
    return torch.stack([
        torch.stack([Wa, Wb, Wc], -1),
        torch.stack([Wb, Wd, We], -1),
        torch.stack([Wc, We, Wf], -1),
    ], -2)


def _normal_equations(J, W, r, w):
    """``H = Σ w JᵀWJ`` and ``g = Σ w JᵀW r`` over the points."""
    WJ = torch.einsum("nab,nbk->nak", W, J)
    H = torch.einsum("nak,nal,n->kl", J, WJ, w)
    g = torch.einsum("nak,na,n->k", WJ, r, w)
    return H, g


def _solve(H: np.ndarray, g: np.ndarray) -> np.ndarray:
    """``−(H + 1e-6·tr(H)/n·I)⁻¹ g`` by Cholesky in float32 on the host
    (JAX ``cho_factor``/``cho_solve``); NaN where the factorisation fails."""
    n = H.shape[0]
    A = (H + np.float32(1e-6) * np.trace(H) / np.float32(n) * np.eye(n, dtype=np.float32)).astype(
        np.float32)
    try:
        L = np.linalg.cholesky(A)
    except np.linalg.LinAlgError:
        return np.full((n,), np.nan, np.float32)
    y = np.linalg.solve(L, g.astype(np.float32))
    return (-np.linalg.solve(L.T, y)).astype(np.float32)


def _result(pose, M, d2, corr, it, H6, twist_free: bool, want_hessian: bool) -> SkewIcpResult:
    dtype, dev = d2.dtype, d2.device
    n_corr = corr.sum(dtype=torch.int32)
    fitness = torch.where(
        n_corr > 0,
        torch.where(corr, d2, torch.zeros_like(d2)).sum() / torch.clamp(n_corr, min=1),
        torch.full((), float("inf"), dtype=dtype, device=dev),
    )
    finite = torch.isfinite(pose.t).all() & torch.isfinite(pose.q).all() & torch.isfinite(M).all()
    safe_pose = se3.where(finite, pose, se3.identity(dtype=dtype, device=dev))
    twist = torch.where(finite, M, torch.zeros_like(M)) if twist_free else se3.se3_log(safe_pose)
    hessian = None
    if want_hessian:
        H6 = torch.from_numpy(H6).to(dev)
        hessian = torch.where(torch.isfinite(H6).all(), H6, torch.zeros_like(H6))
    return SkewIcpResult(
        pose=safe_pose, skew_twist=twist, fitness=fitness,
        converged=(n_corr >= MIN_CORRESPONDENCES) & finite,
        num_correspondences=n_corr,
        iterations=torch.tensor(it, dtype=torch.int32, device=dev),
        hessian=hessian,
    )


def coupled_deskew_icp(
    source: PointCloud,
    target: PointCloud,
    target_u: torch.Tensor,
    config,
    source_u: Optional[torch.Tensor] = None,
    init: Optional[Pose] = None,
    source_covs: Optional[torch.Tensor] = None,
    target_covs: Optional[torch.Tensor] = None,
    target_valid_len: Optional[torch.Tensor] = None,
    free_source_twist: bool = False,
    source_twist_prior_weight: float = 1.0,
    prior_huber_delta: float = 0.0,
    auto_prior: tuple | None = None,
    want_hessian: bool = False,
) -> SkewIcpResult:
    """Register the skewed ``source`` onto the skewed ``target``, de-skewing
    both with the transform being solved (JAX contract).

    Model, with ``m = log(pose)``: ``p'(u) = p + u·(t_m + ω_m × p)`` for the
    source (``source_u=None`` takes it as clean), ``q'(v)`` likewise for the
    target, ``r = R·p' + t − q'``, left perturbation. The residuals use the
    exact warp (``deskew_points``), the Jacobian its first order.
    ``free_source_twist`` frees the source twist M (6 more unknowns) with
    the prior ``M → log(pose)`` of information ``source_twist_prior_weight``
    per 1,000 source points, Huber-weighted when ``prior_huber_delta > 0``.
    ``auto_prior = (w_straight, w_turn, threshold)`` uses ``w_straight``
    until the pose's rotation angle exceeds ``threshold`` in this solve,
    then ``w_turn`` for the rest of it (a latch).
    """
    pts = source.points
    dev, dtype = pts.device, pts.dtype
    if init is None:
        init = se3.identity(dtype=dtype, device=dev)
    plane = config.mode == "plane"
    if plane and (source_covs is None or target_covs is None):
        raise ValueError("plane mode requires source_covs and target_covs")
    if free_source_twist and source_u is None:
        raise ValueError("free_source_twist requires source_u — a clean source has no "
                         "sweep twist to estimate")

    n = pts.shape[0]
    q_pts = target.points
    v_all = target_u.to(dtype)
    u_src = None if source_u is None else source_u.to(dtype)
    max_d2 = config.max_correspondence_distance ** 2
    ndof = 12 if free_source_twist else 6
    f32 = np.float32
    eye6 = np.eye(6, dtype=f32)

    pose = init
    M = se3.se3_log(init) if free_source_twist else torch.zeros(6, dtype=dtype, device=dev)
    it, dnorm, relaxed = 0, float("inf"), False
    d2 = torch.full((n,), float("inf"), dtype=dtype, device=dev)
    corr = torch.zeros(n, dtype=torch.bool, device=dev)
    H6 = np.zeros((6, 6), f32)
    while it < config.max_iterations and dnorm > config.transformation_epsilon:
        R = quat.to_matrix(pose.q)
        if u_src is None:
            p_warp = pts
        elif free_source_twist:
            p_warp = deskew_points(pts, u_src, se3.se3_exp(M))
        else:
            p_warp = deskew_points(pts, u_src, pose)
        P = (p_warp @ R.T + pose.t[None, :]).contiguous()
        q_warp = deskew_points(q_pts, v_all, pose).contiguous()
        res = nn_ops.nearest_neighbors(
            P, q_warp, target.mask, valid_len=target_valid_len, prune_beyond=float(max_d2)
        )
        idx = res.idx
        matched = torch.isfinite(res.dist2)
        q0, v = q_pts[idx], v_all[idx]
        r = P - q_warp[idx]
        d2 = (r * r).sum(-1)
        corr = source.mask & matched & (d2 <= max_d2)
        w = _huber_weights(torch.sqrt(torch.clamp(d2, min=0.0)), config.huber_delta)
        w = w * corr.to(dtype)
        W = _information(plane, R, source_covs, target_covs, idx, n, pts)

        J = _basis(P) - v[:, None, None] * _basis(q0)
        if u_src is not None:
            J_src = u_src[:, None, None] * torch.einsum("ab,nbk->nak", R, _basis(pts))
            J = torch.cat([J, J_src], dim=-1) if free_source_twist else J + J_src
        H, g = _normal_equations(J, W, r, w)
        extra = [corr.sum().to(dtype)[None], source.mask.sum().to(dtype)[None]]
        if free_source_twist:
            extra.append(M - se3.se3_log(pose))
        if auto_prior is not None:
            extra.append(torch.linalg.norm(se3.so3_log(pose.q))[None])
        s = to_host(torch.cat([H.reshape(-1), g] + extra))
        H = s[: ndof * ndof].reshape(ndof, ndof).copy()
        g = s[ndof * ndof : ndof * ndof + ndof].copy()
        n_corr, n_src = s[ndof * ndof + ndof], s[ndof * ndof + ndof + 1]
        rest = s[ndof * ndof + ndof + 2 :]
        if auto_prior is not None:
            # the latch: the angle of every iterate so far, this one included
            relaxed = relaxed or bool(rest[-1] > f32(auto_prior[2]))
        if free_source_twist:
            rp = rest[:6]
            w_pr = f32(1.0)
            if prior_huber_delta > 0:
                dev_n = np.linalg.norm(rp)
                if not dev_n <= prior_huber_delta:
                    w_pr = f32(prior_huber_delta) / max(dev_n, f32(1e-12))
            if auto_prior is None:
                w_prior = f32(source_twist_prior_weight)
            else:
                w_prior = f32(auto_prior[1] if relaxed else auto_prior[0])
            pw = f32(w_prior * (max(n_src, f32(1.0)) / f32(1000.0))) * f32(w_pr)
            H[:6, :6] += pw * eye6
            H[6:, 6:] += pw * eye6
            H[:6, 6:] -= pw * eye6
            H[6:, :6] -= pw * eye6
            g[:6] -= pw * rp
            g[6:] += pw * rp
            # pose information: the Schur complement of the twist block
            Hmm = H[6:, 6:]
            ridge = f32(1e-6) * np.trace(Hmm) / f32(6.0) + f32(1e-12)
            Hmm_i = np.linalg.inv(Hmm + ridge * eye6).astype(f32)
            H6 = (H[:6, :6] - H[:6, 6:] @ Hmm_i @ H[6:, :6]).astype(f32)
        else:
            H6 = H[:6, :6].copy()
        delta = _solve(H, g)
        if not n_corr >= MIN_CORRESPONDENCES:
            delta = np.zeros(ndof, f32)
        dnorm = float(np.linalg.norm(delta))
        delta_t = torch.from_numpy(delta).to(dev)
        pose = se3.normalize(se3.compose(se3.se3_exp(delta_t[:6]), pose))
        if free_source_twist:
            M = M + delta_t[6:]
        it += 1
    profiling.count("icp.iterations", it)
    return _result(pose, M, d2, corr, it, H6, free_source_twist, want_hessian)


def skew_aware_icp(
    source: PointCloud,
    target: PointCloud,
    config,
    sweep_u: torch.Tensor,
    init: Optional[Pose] = None,
    init_skew: Optional[torch.Tensor] = None,
    source_covs: Optional[torch.Tensor] = None,
    target_covs: Optional[torch.Tensor] = None,
    target_valid_len: Optional[torch.Tensor] = None,
    skew_prior_weight: float = 1.0,
    skew_prior_t_factor: float = 100.0,
    want_hessian: bool = False,
) -> SkewIcpResult:
    """Register the skewed ``source`` (capture fractions ``sweep_u``) onto a
    clean ``target``, solving pose and sweep twist (12 unknowns; JAX
    contract). The source warp is linear, ``p' = p + u·(t_m + ω_m × p)``.
    ``init_skew`` (default zeros) seeds the twist and is its prior's mean;
    the prior's information is ``skew_prior_weight`` per 1,000 source
    points, times ``skew_prior_t_factor`` on the translation."""
    pts = source.points
    dev, dtype = pts.device, pts.dtype
    if init is None:
        init = se3.identity(dtype=dtype, device=dev)
    if init_skew is None:
        init_skew = torch.zeros(6, dtype=dtype, device=dev)
    plane = config.mode == "plane"
    if plane and (source_covs is None or target_covs is None):
        raise ValueError("plane mode requires source_covs and target_covs")

    n = pts.shape[0]
    u = sweep_u.to(dtype)
    max_d2 = config.max_correspondence_distance ** 2
    B = _basis(pts)
    f32 = np.float32
    factors = np.array([skew_prior_t_factor] * 3 + [1.0] * 3, f32)

    pose, M = init, init_skew
    it, dnorm = 0, float("inf")
    d2 = torch.full((n,), float("inf"), dtype=dtype, device=dev)
    corr = torch.zeros(n, dtype=torch.bool, device=dev)
    H6 = np.zeros((6, 6), f32)
    while it < config.max_iterations and dnorm > config.transformation_epsilon:
        R = quat.to_matrix(pose.q)
        tm, wm = M[:3], M[3:]
        p_warp = pts + u[:, None] * (tm[None, :] + torch.linalg.cross(wm.expand(n, 3), pts))
        P = (p_warp @ R.T + pose.t[None, :]).contiguous()
        res = nn_ops.nearest_neighbors(
            P, target.points, target.mask, valid_len=target_valid_len,
            prune_beyond=float(max_d2),
        )
        idx = res.idx
        matched = torch.isfinite(res.dist2)
        r = P - target.points[idx]
        d2 = (r * r).sum(-1)
        corr = source.mask & matched & (d2 <= max_d2)
        w = _huber_weights(torch.sqrt(torch.clamp(d2, min=0.0)), config.huber_delta)
        w = w * corr.to(dtype)
        W = _information(plane, R, source_covs, target_covs, idx, n, pts)
        J_M = u[:, None, None] * torch.einsum("ab,nbk->nak", R, B)
        J = torch.cat([_basis(P), J_M], dim=-1)
        H, g = _normal_equations(J, W, r, w)
        s = to_host(torch.cat([
            H.reshape(-1), g, corr.sum().to(dtype)[None], source.mask.sum().to(dtype)[None],
            M - init_skew,
        ]))
        H = s[:144].reshape(12, 12).copy()
        g = s[144:156].copy()
        n_corr, n_src, dm = s[156], s[157], s[158:164]
        H6 = H[:6, :6].copy()  # data-only pose information
        # the prior M → seed, stiff on the twist's translation
        pw = f32(skew_prior_weight * (max(n_src, f32(1.0)) / f32(1000.0))) * factors
        H[6:, 6:] += np.diag(pw)
        g[6:] += pw * dm
        delta = _solve(H, g)
        if not n_corr >= MIN_CORRESPONDENCES:
            delta = np.zeros(12, f32)
        dnorm = float(np.linalg.norm(delta))
        delta_t = torch.from_numpy(delta).to(dev)
        pose = se3.normalize(se3.compose(se3.se3_exp(delta_t[:6]), pose))
        M = M + delta_t[6:]
        it += 1
    profiling.count("icp.iterations", it)
    return _result(pose, M, d2, corr, it, H6, True, want_hessian)
