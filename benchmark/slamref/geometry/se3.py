"""Batched SE(3) poses (port of ``icpslam_tpu/geometry/se3.py``).

``Pose`` is a NamedTuple of ``t`` (..., 3) and ``q`` (..., 4, wxyz).
``compose`` is the group product, ``relative(a, b) = a⁻¹ ∘ b``, and the
so(3)/se(3) exp/log maps are closed-form with small-angle Taylor guards,
so they stay finite at zero angle.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slamref.geometry import quaternion as quat

_EPS = 1e-8


class Pose(NamedTuple):
    t: torch.Tensor  # (..., 3)
    q: torch.Tensor  # (..., 4) unit quaternion, wxyz


def identity(shape=(), dtype=torch.float32, device=None) -> Pose:
    return Pose(
        t=torch.zeros(tuple(shape) + (3,), dtype=dtype, device=device),
        q=quat.identity(shape, dtype, device),
    )


def from_matrix(m: torch.Tensor) -> Pose:
    """Pose from a homogeneous (..., 4, 4) (or (..., 3, 4)) matrix."""
    return Pose(t=m[..., :3, 3], q=quat.from_matrix(m[..., :3, :3]))


def compose(a: Pose, b: Pose) -> Pose:
    return Pose(t=a.t + quat.rotate(a.q, b.t), q=quat.multiply(a.q, b.q))


def inverse(a: Pose) -> Pose:
    qi = quat.conjugate(a.q)
    return Pose(t=-quat.rotate(qi, a.t), q=qi)


def relative(a: Pose, b: Pose) -> Pose:
    return compose(inverse(a), b)


def transform_points(p: Pose, pts: torch.Tensor) -> torch.Tensor:
    """Apply the pose to points ``(..., N, 3)``."""
    return quat.rotate(p.q[..., None, :], pts) + p.t[..., None, :]


def distance_translation(a: Pose, b: Pose) -> torch.Tensor:
    return torch.linalg.norm(a.t - b.t, dim=-1)


def distance_rotation(a: Pose, b: Pose) -> torch.Tensor:
    return quat.angle(quat.multiply(quat.conjugate(a.q), b.q))


def normalize(a: Pose) -> Pose:
    return Pose(t=a.t, q=quat.normalize(a.q))


def where(cond, a: Pose, b: Pose) -> Pose:
    """Element-select between two poses on a (broadcastable) bool."""
    cond = torch.as_tensor(cond, device=a.t.device)
    return Pose(
        t=torch.where(cond[..., None], a.t, b.t),
        q=torch.where(cond[..., None], a.q, b.q),
    )


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    n2 = (w * w).sum(-1, keepdim=True)
    small = n2 < 1e-12
    theta = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    half = 0.5 * theta
    qw = torch.where(small, 1.0 - n2 / 8.0, torch.cos(half))
    scale = torch.where(small, 0.5 - n2 / 48.0, torch.sin(half) / theta)
    return torch.cat([qw, scale * w], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    q = torch.where(q[..., :1] < 0, -q, q)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    xyz = q[..., 1:]
    n2 = (xyz * xyz).sum(-1, keepdim=True)
    small = n2 < 1e-12
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    theta = 2.0 * torch.atan2(n, w)
    scale = torch.where(small, 2.0 / torch.clamp(w, min=_EPS), theta / n)
    return scale * xyz


def skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def _eye3_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    theta2 = (w * w).sum(-1)[..., None, None]
    small = theta2 < 1e-8
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(t2)
    W = skew(w)
    W2 = W @ W
    A = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(t)) / t2)
    B = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (t - torch.sin(t)) / (t2 * t)
    )
    return _eye3_like(W) + A * W + B * W2


def _so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta2 = (w * w).sum(-1)[..., None, None]
    small = theta2 < 1e-8
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(t2)
    W = skew(w)
    W2 = W @ W
    half_t = 0.5 * t
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half_t * torch.cos(half_t) / torch.sin(half_t)) / t2,
    )
    return _eye3_like(W) - 0.5 * W + cot_term * W2


def se3_exp(xi: torch.Tensor) -> Pose:
    """Twist (..., 6) = [rho, w] → Pose with t = J_l(w) rho."""
    rho, w = xi[..., :3], xi[..., 3:]
    q = so3_exp(w)
    t = (_so3_left_jacobian(w) @ rho[..., :, None])[..., 0]
    return Pose(t=t, q=q)


def se3_log(p: Pose) -> torch.Tensor:
    w = so3_log(p.q)
    rho = (_so3_left_jacobian_inv(w) @ p.t[..., :, None])[..., 0]
    return torch.cat([rho, w], dim=-1)


def _se3_Q(xi: torch.Tensor) -> torch.Tensor:
    """Barfoot's Q(ξ), the off-diagonal block of the SE(3) left Jacobian."""
    rho, phi = xi[..., :3], xi[..., 3:]
    P = skew(rho)
    W = skew(phi)
    theta2 = (phi * phi).sum(-1)[..., None, None]
    small = theta2 < 1e-8
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(t2)
    c1 = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (t - torch.sin(t)) / (t2 * t)
    )
    c2 = torch.where(
        small,
        -1.0 / 24.0 + theta2 / 720.0,
        (1.0 - theta2 / 2.0 - torch.cos(t)) / (t2 * t2),
    )
    c3 = torch.where(
        small,
        -1.0 / 120.0 + theta2 / 5040.0,
        (t - torch.sin(t) - t2 * t / 6.0) / (t2 * t2 * t),
    )
    WP = W @ P
    PW = P @ W
    WPW = WP @ W
    W2 = W @ W
    return (
        0.5 * P
        + c1 * (WP + PW + WPW)
        - c2 * (W2 @ P + P @ W2 - 3.0 * WPW)
        - 0.5 * (c2 - 3.0 * c3) * (WP @ W2 + W2 @ PW)
    )


def se3_left_jacobian_inv(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6, 6): [[Jl⁻¹, −Jl⁻¹ Q Jl⁻¹], [0, Jl⁻¹]]."""
    Jli = _so3_left_jacobian_inv(xi[..., 3:])
    Q = _se3_Q(xi)
    top = torch.cat([Jli, -(Jli @ Q @ Jli)], dim=-1)
    bottom = torch.cat([torch.zeros_like(Jli), Jli], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def se3_right_jacobian_inv(xi: torch.Tensor) -> torch.Tensor:
    return se3_left_jacobian_inv(-xi)


def adjoint(p: Pose) -> torch.Tensor:
    R = quat.to_matrix(p.q)
    top = torch.cat([R, skew(p.t) @ R], dim=-1)
    bottom = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def stack(poses) -> Pose:
    """Stack a list of ``Pose`` into a batched ``Pose``."""
    return Pose(t=torch.stack([p.t for p in poses]), q=torch.stack([p.q for p in poses]))


def index(p: Pose, i) -> Pose:
    return Pose(t=p.t[i], q=p.q[i])

