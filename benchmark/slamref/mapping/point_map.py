"""Append-only point map with distance-gated dedup (port of
``icpslam_tpu/mapping/point_map.py``).

A flat (C, 3) buffer, the packed (6, C) GICP covariance of every stored
point, a live ``size`` and an ``overflow`` counter. Queries are the exact
1-NN kernel K1 with ``valid_len = size``: ``size`` stays a device scalar
that the kernel reads from device memory, so a query costs no host sync
and sweeps only the live prefix.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from slamref.cloud.pointcloud import PointCloud
from slamref.cloud.voxel import voxel_downsample
from slamref.ops import nn as nn_ops
from slamref.ops.covariance import eye6


class MapNNResult(NamedTuple):
    points: torch.Tensor  # (Q, 3) nearest map point (zeros when not found)
    dist2: torch.Tensor   # (Q,) squared distance (inf when not found)
    found: torch.Tensor   # (Q,) bool


class PointMap(NamedTuple):
    points: torch.Tensor    # (C, 3)
    covs: torch.Tensor      # (6, C) packed covariances, map frame
    size: torch.Tensor      # int32 live points
    overflow: torch.Tensor  # int32 points dropped (or evicted) at capacity

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def occupancy_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.points.device) < self.size


def empty_map(capacity: int, dtype=torch.float32, device=None) -> PointMap:
    return PointMap(
        points=torch.zeros((capacity, 3), dtype=dtype, device=device),
        covs=eye6(capacity, dtype, device),
        size=torch.tensor(0, dtype=torch.int32, device=device),
        overflow=torch.tensor(0, dtype=torch.int32, device=device),
    )


def reset(pmap: PointMap) -> PointMap:
    return empty_map(pmap.capacity, pmap.points.dtype, pmap.points.device)


def _append(
    pmap: PointMap,
    points: torch.Tensor,
    new: torch.Tensor,
    covs: Optional[torch.Tensor],
    eviction: str = "none",
) -> PointMap:
    """Scatter-append the ``new``-masked points (and covariances); with
    ``eviction='ring'`` a full map overwrites its oldest points."""
    C = pmap.capacity
    dev = points.device
    new_i = new.to(torch.int32)
    n_new = new_i.sum(dtype=torch.int32)
    if eviction == "ring":
        rank = torch.cumsum(new_i, 0)
        new = new & ((n_new - rank) < C)
        start = pmap.size + pmap.overflow
        pos = start + torch.cumsum(new.to(torch.int32), 0) - 1
        pos = torch.where(new, pos % C, torch.full_like(pos, C))
    else:
        pos = pmap.size + torch.cumsum(new_i, 0) - 1
        pos = torch.where(new & (pos < C), pos, torch.full_like(pos, C))
    pos = pos.long()
    # one scratch row past the end takes every dropped write
    out_points = torch.cat([pmap.points, pmap.points.new_zeros((1, 3))])
    out_points[pos] = points
    packed = eye6(points.shape[0], pmap.covs.dtype, dev) if covs is None else covs
    out_covs = torch.cat([pmap.covs, pmap.covs.new_zeros((6, 1))], 1)
    out_covs[:, pos] = packed
    total = pmap.size + n_new
    return PointMap(
        points=out_points[:C],
        covs=out_covs[:, :C],
        size=torch.clamp(total, max=C).to(torch.int32),
        overflow=(pmap.overflow + torch.clamp(total - C, min=0)).to(torch.int32),
    )


def insert(
    pmap: PointMap,
    cloud: PointCloud,
    resolution: float,
    covs: Optional[torch.Tensor] = None,
    eviction: str = "none",
) -> PointMap:
    """Distance-gated append of a map-frame cloud (voxel pass + one NN sweep)."""
    filt, _ = voxel_downsample(cloud, resolution, cloud.capacity)
    res = nn_ops.nearest_neighbors(
        filt.points, pmap.points, pmap.occupancy_mask(), valid_len=pmap.size
    )
    new = filt.mask & ~(res.dist2 < resolution * resolution)
    return _append(pmap, filt.points, new, covs, eviction=eviction)


def insert_with_nn(
    pmap: PointMap,
    cloud: PointCloud,
    resolution: float,
    nn_dist2: torch.Tensor,
    covs: Optional[torch.Tensor] = None,
    eviction: str = "none",
) -> PointMap:
    """Distance-gated append reusing each point's known NN distance."""
    new = cloud.mask & ~(nn_dist2 < resolution * resolution)
    return _append(pmap, cloud.points, new, covs, eviction=eviction)


def exact_nn(pmap: PointMap, points: torch.Tensor, mask: torch.Tensor) -> MapNNResult:
    """Exact NN of the queries against the live map: K1 with ``valid_len``
    over the prefix the append-only map fills."""
    return _exact_nn_idx(pmap, points, mask)[0]


def exact_nn_with_covs(
    pmap: PointMap, points: torch.Tensor, mask: torch.Tensor,
    prune_beyond: float | None = None,
) -> Tuple[MapNNResult, torch.Tensor]:
    """Exact NN against the live map plus each winner's stored covariance
    (identity where nothing was found)."""
    nn, idx = _exact_nn_idx(pmap, points, mask, prune_beyond)
    covs = torch.where(nn.found[None, :], pmap.covs[:, idx],
                       eye6(points.shape[0], pmap.covs.dtype, points.device))
    return nn, covs


def _exact_nn_idx(pmap: PointMap, points: torch.Tensor, mask: torch.Tensor,
                  prune_beyond: float | None = None) -> Tuple[MapNNResult, torch.Tensor]:
    res = nn_ops.nearest_neighbors(
        points, pmap.points, pmap.occupancy_mask(), valid_len=pmap.size,
        prune_beyond=prune_beyond,
    )
    found = mask & torch.isfinite(res.dist2)
    nn = MapNNResult(
        points=torch.where(found[:, None], pmap.points[res.idx], 0.0),
        dist2=torch.where(found, res.dist2, float("inf")),
        found=found,
    )
    return nn, res.idx
