"""Iterative closest point (port of ``icpslam_tpu/ops/icp.py``).

Point-to-point (Kabsch/Horn) and GICP plane-to-plane (one Gauss-Newton
step per iteration with fused covariance weighting ``(C_dst + R C_src Rᵀ)⁻¹``),
with Huber weights, fixed correspondences, correspondence refresh, exact
fitness and the final GN Hessian.

The JAX ``lax.while_loop`` becomes a Python loop with one host read per
iteration: the per-point work (transform, NN kernel, residuals, the 27 GN
or 16 Kabsch accumulators) runs on the tensors' device and reduces to a
handful of sums; those come to the host in the iteration's single sync,
where the 6×6 solve (or the 4×4 Horn eigenproblem) and the early-exit test
run. The mapping ICP exits after 2-3 of its 30 iterations, which a masked
fixed-length device loop would pay for in full.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from icpslam_tpu_torch.cloud.pointcloud import PointCloud
from icpslam_tpu_torch.geometry import quaternion as quat
from icpslam_tpu_torch.geometry import se3
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.ops import nn as nn_ops
from icpslam_tpu_torch.ops.kabsch import rigid_align_from_sums, rigid_align_sums
from icpslam_tpu_torch.ops.linalg3 import (
    inv_sym3_comps,
    rotate_sym3_comps,
    solve_chol_unrolled,
)
from icpslam_tpu_torch.utils import profiling
from icpslam_tpu_torch.utils.sync import to_host

MIN_CORRESPONDENCES = 10


class IcpResult(NamedTuple):
    pose: Pose                      # maps source frame → target frame
    fitness: torch.Tensor           # mean squared correspondence distance
    converged: torch.Tensor         # bool
    num_correspondences: torch.Tensor
    iterations: torch.Tensor
    hessian: Optional[torch.Tensor] = None  # (6, 6) JᵀWJ at the final pose


def _huber_weights(dist: torch.Tensor, delta: float) -> torch.Tensor:
    if delta <= 0:
        return torch.ones_like(dist)
    safe = torch.clamp(dist, min=1e-12)
    return torch.where(dist <= delta, torch.ones_like(dist), delta / safe)


def _gn_terms(Wa, Wb, Wc, Wd, We, Wf, px, py, pz, rx, ry, rz) -> torch.Tensor:
    """(27, N) per-point GN accumulators: rows 0-20 JᵀWJ, 21-26 JᵀW r."""
    ux = Wa * rx + Wb * ry + Wc * rz
    uy = Wb * rx + Wd * ry + We * rz
    uz = Wc * rx + We * ry + Wf * rz
    m00 = Wb * pz - Wc * py
    m01 = Wc * px - Wa * pz
    m02 = Wa * py - Wb * px
    m10 = Wd * pz - We * py
    m11 = We * px - Wb * pz
    m12 = Wb * py - Wd * px
    m20 = We * pz - Wf * py
    m21 = Wf * px - Wc * pz
    m22 = Wc * py - We * px
    br00 = pz * m10 - py * m20
    br01 = pz * m11 - py * m21
    br02 = pz * m12 - py * m22
    br11 = px * m21 - pz * m01
    br12 = px * m22 - pz * m02
    br22 = py * m02 - px * m12
    cx = py * uz - pz * uy
    cy = pz * ux - px * uz
    cz = px * uy - py * ux
    return torch.stack(
        [Wa, Wb, Wc, Wd, We, Wf,
         m00, m01, m02, m10, m11, m12, m20, m21, m22,
         br00, br01, br02, br11, br12, br22,
         ux, uy, uz, cx, cy, cz]
    )


# 6×6 H from the 21 reduced accumulator sums: H[r, c] = sign · s[idx]
_H_IDX = np.array([
    [0, 1, 2, 6, 7, 8],
    [1, 3, 4, 9, 10, 11],
    [2, 4, 5, 12, 13, 14],
    [6, 9, 12, 15, 16, 17],
    [7, 10, 13, 16, 18, 19],
    [8, 11, 14, 17, 19, 20],
])
_H_SIGN = np.kron(np.array([[1.0, -1.0], [-1.0, 1.0]]), np.ones((3, 3))).astype(np.float32)


def _gn_hessian(s):
    """H from the sums, on the host (numpy) or the device (torch)."""
    if isinstance(s, torch.Tensor):
        idx = torch.from_numpy(_H_IDX).to(s.device)
        return s[idx] * torch.from_numpy(_H_SIGN).to(s.device, s.dtype)
    return (s[_H_IDX] * _H_SIGN).astype(np.float32)


def icp(
    source: PointCloud,
    target: PointCloud,
    config,
    init: Optional[Pose] = None,
    source_covs: Optional[torch.Tensor] = None,
    target_covs: Optional[torch.Tensor] = None,
    target_valid_len: Optional[torch.Tensor] = None,
    fixed_correspondences: bool = False,
    want_hessian: bool = False,
) -> IcpResult:
    """Register ``source`` onto ``target``; returns the target-frame pose.

    Same contract as the JAX ``icp``: plane mode needs packed (6, N) /
    (6, M) covariances; ``fixed_correspondences`` pairs source point i
    with target point i; ``target_valid_len`` (0-d int32 device tensor) is
    the live prefix of a prefix-packed target.
    """
    pts = source.points
    dev, dtype = pts.device, pts.dtype
    if init is None:
        init = se3.identity(dtype=dtype, device=dev)
    plane = config.mode == "plane"
    if plane and (source_covs is None or target_covs is None):
        raise ValueError("plane mode requires source_covs and target_covs")
    max_d2 = config.max_correspondence_distance ** 2
    eps = config.transformation_epsilon
    refresh = max(1, config.correspondence_refresh)

    sx, sy, sz = pts.unbind(-1)
    tp3 = target.points.T
    if plane:
        sc = tuple(source_covs.unbind(0))

    def transform_comps(pose: Pose):
        R = quat.to_matrix(pose.q)
        px = R[0, 0] * sx + R[0, 1] * sy + R[0, 2] * sz + pose.t[0]
        py = R[1, 0] * sx + R[1, 1] * sy + R[1, 2] * sz + pose.t[1]
        pz = R[2, 0] * sx + R[2, 1] * sy + R[2, 2] * sz + pose.t[2]
        return R, px, py, pz

    def fresh_nn(px, py, pz):
        res = nn_ops.nearest_neighbors(
            torch.stack([px, py, pz], dim=-1), target.points, target.mask,
            valid_len=target_valid_len, prune_beyond=float(max_d2),
        )
        return res.idx, torch.isfinite(res.dist2)

    def match_eval(idx, matched, px, py, pz):
        d = tp3[:, idx]
        rx, ry, rz = px - d[0], py - d[1], pz - d[2]
        d2 = rx * rx + ry * ry + rz * rz
        corr = source.mask & matched & (d2 <= max_d2)
        return (rx, ry, rz), d2, corr

    def fused_weights(R, idx):
        ba, bb, bc, bd, be, bf = rotate_sym3_comps(R, sc)
        tg = target_covs[:, idx]
        return inv_sym3_comps(
            tg[0] + ba, tg[1] + bb, tg[2] + bc, tg[3] + bd, tg[4] + be, tg[5] + bf
        )

    n_src = pts.shape[0]
    if fixed_correspondences:
        if target.points.shape[0] != n_src:
            raise ValueError("fixed_correspondences requires target and source of equal size")
        ident_idx = torch.arange(n_src, device=dev)
        ident_matched = target.mask

    pose = init
    it = 0
    dnorm = float("inf")
    idx = torch.zeros(n_src, dtype=torch.int64, device=dev)
    matched = torch.zeros(n_src, dtype=torch.bool, device=dev)
    d2 = torch.full((n_src,), float("inf"), dtype=dtype, device=dev)
    corr = torch.zeros(n_src, dtype=torch.bool, device=dev)

    while it < config.max_iterations:
        small = dnorm <= eps
        if refresh > 1 and not fixed_correspondences:
            small = small and ((it - 1) % refresh == 0)
        if small:
            break
        R, px, py, pz = transform_comps(pose)
        if fixed_correspondences:
            idx, matched = ident_idx, ident_matched
        elif it % refresh == 0:
            idx, matched = fresh_nn(px, py, pz)
        (rx, ry, rz), d2, corr = match_eval(idx, matched, px, py, pz)
        w = _huber_weights(torch.sqrt(torch.clamp(d2, min=0.0)), config.huber_delta)
        w = w * corr.to(dtype)
        n_corr = corr.sum().to(dtype)
        if not plane:
            d = tp3[:, idx]
            s = to_host(torch.cat([rigid_align_sums(px, py, pz, d[0], d[1], d[2], w), n_corr[None]]))
            delta_pose, _ = rigid_align_from_sums(torch.from_numpy(s[:16]))
            dnorm = float(torch.linalg.norm(se3.se3_log(delta_pose)))
            delta_pose = Pose(t=delta_pose.t.to(dev), q=delta_pose.q.to(dev))
        else:
            Wa, Wb, Wc, Wd, We, Wf = fused_weights(R, idx)
            terms = _gn_terms(Wa, Wb, Wc, Wd, We, Wf, px, py, pz, rx, ry, rz)
            s = to_host(torch.cat([(terms * w).sum(1), n_corr[None]]))
            delta = solve_chol_unrolled(_gn_hessian(s), -s[21:27], damping=1e-6)
            if not s[27] >= MIN_CORRESPONDENCES:
                delta = np.zeros(6, np.float32)
            dnorm = float(np.linalg.norm(delta))
            delta_pose = se3.se3_exp(torch.from_numpy(delta).to(dev))
        pose = se3.normalize(se3.compose(delta_pose, pose))
        it += 1
    profiling.count("icp.iterations", it)

    if config.exact_fitness:
        _, px, py, pz = transform_comps(pose)
        if fixed_correspondences:
            f_idx, f_matched = ident_idx, ident_matched
        else:
            f_idx, f_matched = fresh_nn(px, py, pz)
        _, d2, corr = match_eval(f_idx, f_matched, px, py, pz)
    n_corr = corr.sum(dtype=torch.int32)
    fitness = torch.where(
        n_corr > 0,
        torch.where(corr, d2, torch.zeros_like(d2)).sum() / torch.clamp(n_corr, min=1),
        torch.full((), float("inf"), dtype=dtype, device=dev),
    )
    pose_finite = torch.isfinite(pose.t).all() & torch.isfinite(pose.q).all()
    converged = (n_corr >= MIN_CORRESPONDENCES) & pose_finite
    safe_pose = se3.where(pose_finite, pose, se3.identity(dtype=dtype, device=dev))

    hessian = None
    if want_hessian:
        Rf, fpx, fpy, fpz = transform_comps(safe_pose)
        fidx, fmatched = (ident_idx, ident_matched) if fixed_correspondences else (idx, matched)
        (frx, fry, frz), fd2, fcorr = match_eval(fidx, fmatched, fpx, fpy, fpz)
        fw = _huber_weights(torch.sqrt(torch.clamp(fd2, min=0.0)), config.huber_delta)
        fw = fw * fcorr.to(dtype)
        if plane:
            W = fused_weights(Rf, fidx)
        else:
            one, zero = torch.ones_like(fpx), torch.zeros_like(fpx)
            W = (one, zero, zero, one, zero, one)
        terms = _gn_terms(*W, fpx, fpy, fpz, frx, fry, frz)
        H = _gn_hessian((terms * fw).sum(1))
        hessian = torch.where(torch.isfinite(H).all(), H, torch.zeros_like(H))

    return IcpResult(
        pose=safe_pose,
        fitness=fitness,
        converged=converged,
        num_correspondences=n_corr,
        iterations=torch.tensor(it, dtype=torch.int32, device=dev),
        hessian=hessian,
    )
