"""Motion de-skew of spinning-lidar sweeps (port of ``icpslam_tpu/cloud/deskew.py``).

A sweep of a mechanical lidar is smeared by the platform's motion during
the sweep. Each point's capture-time fraction comes from its azimuth
(the scanner sweeps [-π, π) once per period): ``u = (atan2(y, x) + π) / 2π``.
The warp is the constant-velocity interpolation ``p' = R(u·θ)·p + u·t``
(axis fixed, angle scaled), in Rodrigues component form, elementwise on
the tensors' device. The in-loop de-skew of ``pipeline/odometry.py`` and
``ops/skew_icp.py`` uses it; the runner's INS de-skew at ingest is the
host version, ``io/synthetic.deskew_scan``.

At ``y = ±0, x < 0`` ``atan2`` gives ±π, so ``u`` is ~0 on one side of the
sweep's seam and ~1 on the other: the warp of two such points differs by
a whole sweep's motion. That is the model (the seam is where the sweep
starts and ends), and the JAX version does the same.
"""

from __future__ import annotations

import math

import torch

from slamref.geometry.se3 import Pose


def sweep_fraction(points: torch.Tensor) -> torch.Tensor:
    """(N,) capture-time fraction in [0, 1] from point azimuth."""
    az = torch.atan2(points[:, 1], points[:, 0])
    return (az + math.pi) / (2.0 * math.pi)


def deskew_points(points: torch.Tensor, u: torch.Tensor, rel: Pose) -> torch.Tensor:
    """Re-express sweep points in the sweep-START frame: each point at
    fraction ``u`` goes through ``T(u) = (u·t, q^u)`` of the sweep motion
    ``rel`` (start → end)."""
    px, py, pz = points.unbind(-1)
    q = rel.q
    # axis-angle of rel.q (shortest arc)
    w = q[0].abs()
    v = q[1:] * torch.sign(torch.where(q[0] == 0.0, torch.ones_like(q[0]), q[0]))
    s = torch.linalg.norm(v)
    theta = 2.0 * torch.atan2(s, w)
    axis = v / torch.clamp(s, min=1e-12)
    ax, ay, az = axis.unbind(-1)

    ang = u * theta
    c, sn = torch.cos(ang), torch.sin(ang)
    # Rodrigues: p' = p·c + (a×p)·s + a·(a·p)·(1−c)
    dot = ax * px + ay * py + az * pz
    cx = ay * pz - az * py
    cy = az * px - ax * pz
    cz = ax * py - ay * px
    k = dot * (1.0 - c)
    rx = px * c + cx * sn + ax * k + u * rel.t[0]
    ry = py * c + cy * sn + ay * k + u * rel.t[1]
    rz = pz * c + cz * sn + az * k + u * rel.t[2]
    return torch.stack([rx, ry, rz], dim=-1)
