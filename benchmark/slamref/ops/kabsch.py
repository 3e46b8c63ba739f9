"""Weighted rigid alignment, Horn's quaternion method (port of
``icpslam_tpu/ops/kabsch.py``).

Split in two halves so that the ICP loop needs one device sync per
iteration: :func:`rigid_align_sums` reduces the 16 weighted sums on the
tensors' device, and :func:`rigid_align_from_sums` solves the 4×4 Horn
eigenproblem from them on the host (float32 LAPACK, as the JAX version's
``eigh`` on CPU).
"""

from __future__ import annotations

from typing import Tuple

import torch

from slamref.geometry import quaternion as quat
from slamref.geometry.se3 import Pose


def rigid_align_sums(px, py, pz, dx, dy, dz, weights: torch.Tensor) -> torch.Tensor:
    """(16,) sums ``[Σw, Σw·s, Σw·d, Σw·s_a·d_b]`` of the JAX version."""
    w = weights.to(px.dtype)
    terms = torch.stack(
        [torch.ones_like(px), px, py, pz, dx, dy, dz,
         px * dx, px * dy, px * dz,
         py * dx, py * dy, py * dz,
         pz * dx, pz * dy, pz * dz]
    )
    return (terms * w).sum(1)


def rigid_align_from_sums(
    s: torch.Tensor, min_total_weight: float = 1e-6
) -> Tuple[Pose, bool]:
    """Best-fit pose from the 16 sums of :func:`rigid_align_sums`, on a
    CPU float32 tensor. Returns ``(pose, ok)``; identity when the total
    weight is (numerically) zero."""
    W = s[0]
    ok = bool(W > min_total_weight)
    Wsafe = torch.clamp(W, min=min_total_weight)
    cs = s[1:4] / Wsafe
    cd = s[4:7] / Wsafe
    S = s[7:16].reshape(3, 3) - s[1:4, None] * s[None, 4:7] / Wsafe
    Sxx, Sxy, Sxz = S[0, 0], S[0, 1], S[0, 2]
    Syx, Syy, Syz = S[1, 0], S[1, 1], S[1, 2]
    Szx, Szy, Szz = S[2, 0], S[2, 1], S[2, 2]
    N = torch.stack(
        [
            torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx]),
            torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz]),
            torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy]),
            torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz]),
        ]
    )
    _, vecs = torch.linalg.eigh(N)
    q = vecs[:, -1]
    q = quat.normalize(torch.where(q[0] < 0, -q, q))
    t = cd - quat.rotate(q, cs)
    if not ok:
        return Pose(t=torch.zeros_like(t), q=quat.identity(dtype=q.dtype)), ok
    return Pose(t=t, q=q), ok


def weighted_rigid_align_comps(px, py, pz, dx, dy, dz, weights: torch.Tensor,
                               min_total_weight: float = 1e-6) -> Tuple[Pose, bool]:
    """:func:`weighted_rigid_align` on six (N,) component tensors (the JAX
    version's structure-of-arrays form): the sums on their device, the
    solve on the host."""
    s = rigid_align_sums(px, py, pz, dx, dy, dz, weights)
    return rigid_align_from_sums(s.detach().cpu(), min_total_weight)


def weighted_rigid_align(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor):
    """Best-fit pose mapping ``src`` (N, 3) onto ``dst`` under ``weights``;
    the sums run on the inputs' device, the solve on the host."""
    s = rigid_align_sums(*src.unbind(-1), *dst.unbind(-1), weights)
    return rigid_align_from_sums(s.detach().cpu())
