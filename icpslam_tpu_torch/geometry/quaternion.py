"""Batched unit-quaternion algebra (port of ``icpslam_tpu/geometry/quaternion.py``).

Quaternions are ``(..., 4)`` tensors stored ``(w, x, y, z)``; every
function broadcasts over leading axes.
"""

from __future__ import annotations

import torch

from icpslam_tpu_torch.utils.device import resolve as resolve_device

_EPS = 1e-12


def identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    # a fill on the device: an indexed assignment of a Python scalar copies
    # it from the host, a sync that a CUDA graph capture refuses
    q[..., 0].fill_(1.0)
    return q


def normalize(q: torch.Tensor) -> torch.Tensor:
    """Unit length, with the zero quaternion mapped to identity."""
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    ok = n > _EPS
    out = q / torch.where(ok, n, torch.ones_like(n))
    return torch.where(ok, out, identity(q.shape[:-1], q.dtype, q.device))


def conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product ``a ⊗ b``."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def _cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    u, v = torch.broadcast_tensors(u, v)
    return torch.linalg.cross(u, v, dim=-1)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate ``v`` (..., 3) by ``q`` (..., 4): ``v + 2(w u×v + u×(u×v))``."""
    u = q[..., 1:]
    w = q[..., :1]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix ``(..., 3, 3)`` from a unit quaternion."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def from_matrix(m: torch.Tensor) -> torch.Tensor:
    """Unit quaternion from a rotation matrix (..., 3, 3), branch-free
    (Shepperd's method): the four candidates, one per largest-diagonal
    hypothesis, and the best selected by index; sign canonical (w ≥ 0)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    # 4w², 4x², 4y², 4z²
    qw2 = torch.clamp(1.0 + tr, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)
    cw = torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    cx = torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1)
    cy = torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1)
    cz = torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1)
    best = torch.stack([qw2, qx2, qy2, qz2], dim=-1).argmax(-1)
    cands = torch.stack([cw, cx, cy, cz], dim=-2)  # (..., 4, 4)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = normalize(torch.gather(cands, -2, idx)[..., 0, :])
    return torch.where(q[..., :1] < 0, -q, q)


def from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Quaternion from a (unit) axis ``(..., 3)`` and an angle ``(...,)`` in radians."""
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None], axis * torch.sin(half)[..., None]], dim=-1)


def from_rpy(roll, pitch, yaw, device=None) -> torch.Tensor:
    """Quaternion from ZYX Euler angles (tf's ``setRPY``). Tensor angles
    keep their device; numbers go to ``device`` (default: the CUDA card;
    raises without one — pass ``device="cpu"`` for the CPU)."""
    if device is None:
        given = [a for a in (roll, pitch, yaw) if isinstance(a, torch.Tensor)]
        device = given[0].device if given else resolve_device(None)
    roll, pitch, yaw = (torch.as_tensor(a, dtype=torch.float32, device=device)
                        for a in (roll, pitch, yaw))
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack(
        torch.broadcast_tensors(
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ),
        dim=-1,
    )


def to_rpy(q: torch.Tensor):
    """ZYX Euler angles ``(roll, pitch, yaw)`` of a quaternion."""
    w, x, y, z = q.unbind(-1)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


def angle(q: torch.Tensor) -> torch.Tensor:
    """Absolute rotation angle in [0, pi]."""
    w = torch.clamp(q[..., 0].abs(), 0.0, 1.0)
    return 2.0 * torch.arccos(w)
