"""Voxel-grid downsampling (port of ``icpslam_tpu/cloud/voxel.py``).

Sort-based, as the JAX version: pack relative voxel coordinates into one
11/11/10-bit int32 key (int32-max marks padding), sort stably with the
points as payload, and take each voxel's centroid from cumulative-sum
differences of voxel-relative offsets. The output order is the key order,
which the JAX package's fixed-correspondence pairing and NN locality rely
on, so it must match the JAX output exactly.
"""

from __future__ import annotations

from typing import Tuple

import torch

from slamref.cloud.pointcloud import PointCloud

SENTINEL: int = 2**24
_PACK_BITS = (11, 11, 10)
_INVALID_KEY = 2**31 - 1


def _over(x: torch.Tensor, resolution: float) -> torch.Tensor:
    """``x / resolution``, correctly rounded on every device. A CUDA tensor
    divided by a Python scalar is multiplied by the scalar's reciprocal,
    which moves points within an ulp of a voxel face into the next voxel;
    a device tensor as the divisor keeps the true division."""
    return x / torch.full((), resolution, dtype=x.dtype, device=x.device)


def voxel_coords(points: torch.Tensor, resolution: float, mask=None) -> torch.Tensor:
    coords = torch.floor(_over(points, resolution)).to(torch.int32)
    if mask is not None:
        coords = torch.where(mask[..., None], coords, torch.full_like(coords, SENTINEL))
    return coords


def _packed_keys(coords: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    bx, by, bz = _PACK_BITS
    base = torch.where(valid[:, None], coords, torch.full_like(coords, 2**22)).amin(0)
    rel = coords - base
    rx = torch.clamp(rel[:, 0], 0, (1 << bx) - 1)
    ry = torch.clamp(rel[:, 1], 0, (1 << by) - 1)
    rz = torch.clamp(rel[:, 2], 0, (1 << bz) - 1)
    key = (rx << (by + bz)) | (ry << bz) | rz
    key = torch.where(key == _INVALID_KEY, key - 1, key)
    return torch.where(valid, key, torch.full_like(key, _INVALID_KEY))


def voxel_downsample(
    cloud: PointCloud, resolution: float, capacity: int
) -> Tuple[PointCloud, torch.Tensor]:
    """One centroid per occupied voxel, in key order, ``capacity`` rows.

    Returns ``(filtered, num_voxels)``; voxels past ``capacity`` are
    dropped in key order and show as ``num_voxels > capacity``.
    """
    p = cloud.points
    dev = p.device
    coords = voxel_coords(p, resolution, cloud.mask)
    keys = _packed_keys(coords, cloud.mask)
    n = keys.shape[0]
    sk, perm = torch.sort(keys, stable=True)
    ps = p[perm]
    px, py, pz = ps.unbind(-1)
    sv = sk != _INVALID_KEY

    starts = torch.ones_like(sv)
    starts[1:] = sk[1:] != sk[:-1]
    starts = starts & sv
    slot = torch.cumsum(starts.to(torch.int32), 0, dtype=torch.int32) - 1
    num_voxels = torch.where(sv.any(), slot[-1] + 1, torch.zeros_like(slot[-1]))

    # cumulative sums of voxel-relative offsets, as the JAX version, but
    # accumulated in float64: a float32 prefix sum rounds at |Σ|·2⁻²⁴
    # (≈5e-4 m at 131k raw points), a float64 one leaves the centroids
    # exact to float32 rounding
    w = sv.to(p.dtype)
    ox = torch.floor(_over(px, resolution)) * resolution
    oy = torch.floor(_over(py, resolution)) * resolution
    oz = torch.floor(_over(pz, resolution)) * resolution
    f64 = torch.float64
    cw = torch.cumsum(w, 0, dtype=f64)
    cx = torch.cumsum(w * (px - ox), 0, dtype=f64)
    cy = torch.cumsum(w * (py - oy), 0, dtype=f64)
    cz = torch.cumsum(w * (pz - oz), 0, dtype=f64)

    # start row of each slot; one writer per slot, dropped rows go to a
    # scratch entry past the end (index capacity + 1)
    take = starts & (slot < capacity)
    dest = torch.where(take, slot, torch.full_like(slot, capacity + 1)).long()
    pos = torch.full((capacity + 2,), n, dtype=torch.int64, device=dev)
    pos.scatter_(0, dest, torch.arange(n, device=dev))
    nxt = pos[1 : capacity + 1]
    pos = pos[:capacity]
    end = torch.clamp(nxt - 1, max=n - 1)
    prev_i = torch.clamp(pos - 1, min=0)
    has_prev = pos > 0

    def seg(c):
        return c[end] - torch.where(has_prev, c[prev_i], torch.zeros_like(c[prev_i]))

    counts = seg(cw)
    occupied = counts > 0
    denom = torch.clamp(counts, min=1.0)
    pos_c = torch.clamp(pos, max=n - 1)
    corner = torch.stack([ox[pos_c], oy[pos_c], oz[pos_c]], dim=-1)
    mean = torch.stack([seg(cx), seg(cy), seg(cz)], dim=-1) / denom[:, None]
    centroids = corner + mean.to(p.dtype)
    centroids = torch.where(occupied[:, None], centroids, torch.zeros_like(centroids))
    return PointCloud(points=centroids, mask=occupied), num_voxels
