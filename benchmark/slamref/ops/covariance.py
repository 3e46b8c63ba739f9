"""Per-point GICP surface covariances (port of ``icpslam_tpu/ops/covariance.py``).

k-NN neighbourhood (kernel K2 on the card) → neighbour moments, or
fixed-radius moments in one pass (kernel K3) → closed-form smallest
eigenvector → the disk regularization ``I − (1−ε)·n nᵀ``. Returned
components-first, packed (6, N) as ``[xx, xy, xz, yy, yz, zz]``. JAX on a TPU selects neighbours with an
approximate top-k at reduced precision; the port's selection is exact,
which is what the JAX package computes on the CPU.
"""

from __future__ import annotations

import torch

from slamref.cloud.pointcloud import PointCloud
from slamref.ops import nn as nn_ops
from slamref.ops import radius_stats
from slamref.ops.linalg3 import smallest_eigenvector_sym3_comps, sym3_comps

EYE6 = (1.0, 0.0, 0.0, 1.0, 0.0, 1.0)


def eye6(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(6, n) packed identity covariances."""
    return torch.tensor(EYE6, dtype=dtype, device=device)[:, None].expand(6, n).contiguous()


def _regularize_comps(comps, good: torch.Tensor, epsilon: float) -> torch.Tensor:
    """``I − (1−ε)·n nᵀ`` from the patch normal; identity where not ``good``."""
    nx, ny, nz = smallest_eigenvector_sym3_comps(*comps)
    s = 1.0 - epsilon
    reg = torch.stack([
        1.0 - s * nx * nx,
        -s * nx * ny,
        -s * nx * nz,
        1.0 - s * ny * ny,
        -s * ny * nz,
        1.0 - s * nz * nz,
    ])
    eye = eye6(reg.shape[1], reg.dtype, reg.device)
    return torch.where(good[None, :], reg, eye)


def gicp_covariances(cloud: PointCloud, k: int = 10, epsilon: float = 1e-3) -> torch.Tensor:
    """GICP-regularized covariances, packed (6, N); padding gets identity."""
    pts = cloud.points
    idx, d2 = nn_ops.knn(pts, pts, cloud.mask, k=k)
    neigh = pts[idx]                       # (N, k, 3)
    w = torch.isfinite(d2).T.to(pts.dtype)  # (k, N)
    nxk, nyk, nzk = (neigh[..., c].T for c in range(3))
    wsum = w.sum(0)
    count = torch.clamp(wsum, min=1.0)
    mx = (w * nxk).sum(0) / count
    my = (w * nyk).sum(0) / count
    mz = (w * nzk).sum(0) / count
    cx, cy, cz = nxk - mx, nyk - my, nzk - mz
    comps = (
        (w * cx * cx).sum(0) / count,
        (w * cx * cy).sum(0) / count,
        (w * cx * cz).sum(0) / count,
        (w * cy * cy).sum(0) / count,
        (w * cy * cz).sum(0) / count,
        (w * cz * cz).sum(0) / count,
    )
    good = (wsum >= 3) & cloud.mask
    return _regularize_comps(comps, good, epsilon)


def gicp_covariances_radius(
    cloud: PointCloud, radius: float, epsilon: float = 1e-3, sigma: float = 0.0
) -> torch.Tensor:
    """GICP covariances, packed (6, N), from fixed-radius neighbourhoods
    (self-moments of the cloud, kernel K3 on the card). ``sigma > 0``
    tapers the weights as ``exp(−d²/2σ²)`` inside the radius.

    A point needs 3 neighbours (itself included) for the hard cutoff, or
    a weight sum ``Σw ≥ 2`` with the taper (its own weight alone is 1);
    the rest, and padding, get identity.
    """
    pts = cloud.points
    count, _, cov = radius_stats.radius_moments(pts, pts, cloud.mask, radius, sigma=sigma)
    good = (count >= (2.0 if sigma > 0 else 3.0)) & cloud.mask
    return _regularize_comps(sym3_comps(cov), good, epsilon)
