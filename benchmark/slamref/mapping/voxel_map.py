"""Global map as a sorted voxel array with occupancy dedup and approximate
NN (port of ``icpslam_tpu/mapping/voxel_map.py``).

The map is a fixed-capacity array of int32 voxel coordinates kept in
lexicographic (x, y, z) order, one representative point per voxel, empty
slots holding the key ``SENTINEL = 2**24`` in all three fields (they sort
last). Membership is a vectorised binary search; insertion appends the
scan's new voxels (first wins: an occupied voxel keeps its point) and
re-sorts; the approximate NN of a query searches the (2r+1)³ voxels
around its own. Overflow at capacity is counted.

The order is the full int32 lexicographic order of JAX's ``lexsort``: three
stable sorts, z then y then x. No packed key is used: the map frame of a
long drive leaves the ±1,024 cells of ``cloud/voxel.py``'s 11/11/10-bit
scan key, and three 21-bit fields cannot hold ``SENTINEL``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from slamref.cloud.pointcloud import PointCloud
from slamref.cloud.voxel import SENTINEL, voxel_coords, voxel_downsample
from slamref.mapping.point_map import MapNNResult


class VoxelMap(NamedTuple):
    keys: torch.Tensor      # (C, 3) int32, lexicographically sorted; SENTINEL = empty
    points: torch.Tensor    # (C, 3) float32 representative point per voxel
    size: torch.Tensor      # int32 live voxels
    overflow: torch.Tensor  # int32 voxels dropped because the map was full

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


def empty_map(capacity: int, dtype=torch.float32, device=None) -> VoxelMap:
    return VoxelMap(
        keys=torch.full((capacity, 3), SENTINEL, dtype=torch.int32, device=device),
        points=torch.zeros((capacity, 3), dtype=dtype, device=device),
        size=torch.tensor(0, dtype=torch.int32, device=device),
        overflow=torch.tensor(0, dtype=torch.int32, device=device),
    )


def reset(vmap: VoxelMap) -> VoxelMap:
    """Discard all map content."""
    return empty_map(vmap.capacity, vmap.points.dtype, vmap.points.device)


def _lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic ``a < b`` over the trailing axis of 3."""
    return (a[..., 0] < b[..., 0]) | (
        (a[..., 0] == b[..., 0])
        & ((a[..., 1] < b[..., 1]) | ((a[..., 1] == b[..., 1]) & (a[..., 2] < b[..., 2])))
    )


def lexsort_order(coords: torch.Tensor) -> torch.Tensor:
    """Stable sort order of (N, 3) int32 rows, x primary, then y, then z."""
    order = torch.argsort(coords[:, 2], stable=True)
    order = order[torch.argsort(coords[order, 1], stable=True)]
    return order[torch.argsort(coords[order, 0], stable=True)]


def _lower_bound(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """First index with ``keys[i] >= q`` (lexicographic), for each query;
    (Q,) int64 in [0, C]."""
    C, Q = keys.shape[0], queries.shape[0]
    lo = torch.zeros(Q, dtype=torch.int64, device=keys.device)
    hi = torch.full((Q,), C, dtype=torch.int64, device=keys.device)
    for _ in range(max(C.bit_length(), 1) + 1):
        mid = (lo + hi) // 2
        less = _lex_less(keys[torch.clamp(mid, 0, C - 1)], queries)
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(less, hi, mid)
    return lo


def lookup(vmap: VoxelMap, coords: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Membership of voxel coords (Q, 3): ``(found (Q,) bool, idx (Q,))``,
    the slot when found, clamped otherwise."""
    C = vmap.capacity
    idx = _lower_bound(vmap.keys, coords)
    idx_c = torch.clamp(idx, 0, C - 1)
    hit = (vmap.keys[idx_c] == coords).all(-1) & (idx < vmap.size)
    return hit, idx_c


def insert(vmap: VoxelMap, cloud: PointCloud, resolution: float) -> VoxelMap:
    """Occupancy-gated insert of a map-frame cloud: one centroid per new
    voxel of the cloud; occupied voxels keep their point (first wins)."""
    C = vmap.capacity
    filt, _ = voxel_downsample(cloud, resolution, cloud.capacity)
    coords = voxel_coords(filt.points, resolution, filt.mask)
    occupied, _ = lookup(vmap, coords)
    new_mask = filt.mask & ~occupied
    new_keys = torch.where(new_mask[:, None], coords, torch.full_like(coords, SENTINEL))
    all_keys = torch.cat([vmap.keys, new_keys], 0)
    all_pts = torch.cat([vmap.points, filt.points], 0)
    kept = lexsort_order(all_keys)[:C]
    total = vmap.size + new_mask.sum(dtype=torch.int32)
    return VoxelMap(
        keys=all_keys[kept],
        points=all_pts[kept],
        size=torch.clamp(total, max=C),
        overflow=vmap.overflow + torch.clamp(total - C, min=0),
    )


def _neighbor_offsets(radius: int, device=None) -> torch.Tensor:
    r = torch.arange(-radius, radius + 1, dtype=torch.int32, device=device)
    gx, gy, gz = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], -1)  # (k, 3)


def approx_nn(
    vmap: VoxelMap, points: torch.Tensor, mask: torch.Tensor, resolution: float, radius: int = 1
) -> MapNNResult:
    """Approximate NN of each query: the nearest map point among the
    (2r+1)³ voxels around the query's voxel (first on ties)."""
    base = voxel_coords(points, resolution, mask)
    offs = _neighbor_offsets(radius, points.device)
    cand = (base[:, None, :] + offs[None, :, :]).reshape(-1, 3)
    hit, idx = lookup(vmap, cand)
    Q, k = points.shape[0], offs.shape[0]
    hit = hit.reshape(Q, k)
    cand_pts = vmap.points[idx].reshape(Q, k, 3)
    d2 = ((points[:, None, :] - cand_pts) ** 2).sum(-1)
    d2 = torch.where(hit, d2, float("inf"))
    best = d2.argmin(-1)
    best_d2 = torch.gather(d2, 1, best[:, None])[:, 0]
    best_pts = cand_pts[torch.arange(Q, device=points.device), best]
    found = torch.isfinite(best_d2) & mask
    return MapNNResult(
        points=torch.where(found[:, None], best_pts, 0.0),
        dist2=torch.where(found, best_d2, float("inf")),
        found=found,
    )
