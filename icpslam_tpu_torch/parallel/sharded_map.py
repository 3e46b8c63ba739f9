"""Spatially sharded voxel map (port of ``icpslam_tpu/parallel/sharded_map.py``).

The voxel map of ``mapping/voxel_map.py`` partitioned over the mesh's
shards by spatial block: voxel coordinates are grouped into coarse blocks
(``2^block_shift`` voxels a side) and a spatial hash gives each block one
owning shard. So:

- **insert** needs no collective: the scan is replicated, and each shard
  keeps the points of the blocks it owns and runs the occupancy-deduped
  voxel insert on them;
- **approx_nn** is a replicated query, the (2r+1)³ search on each shard,
  and a reduction over the shards: ``pmin`` of the distances, ``pmin`` of
  the winning shard id (the lowest wins a tie) and ``psum`` of the
  winner's point and flag — JAX's two steps, not the tie order of an
  argmin.

The map is a ``VoxelMap`` whose leaves carry a leading shard axis: all D
shards, JAX's layout, on a mesh without a process group; this rank's
``local`` shards on one with a group. Each shard has its own capacity.
The per-shard bodies loop over the local shards (the voxel filter and the
sorts of an insert, and the binary searches of a query, run once per
shard).
"""

from __future__ import annotations

import torch

from icpslam_tpu_torch.cloud.pointcloud import PointCloud
from icpslam_tpu_torch.cloud.voxel import voxel_coords
from icpslam_tpu_torch.mapping import voxel_map as vm
from icpslam_tpu_torch.mapping.point_map import MapNNResult
from icpslam_tpu_torch.parallel.mesh import Mesh

BLOCK_SHIFT = 4  # 16^3 voxels per ownership block
_PRIMES = (73856093, 19349663, 83492791)


def owner_of(coords: torch.Tensor, n_devices: int, block_shift: int = BLOCK_SHIFT) -> torch.Tensor:
    """Owning shard (…,) of int32 voxel coords (…, 3), JAX's bit for bit:
    an arithmetic shift, int32 products that wrap, ``abs`` that leaves
    INT32_MIN negative, and a floor modulo (``torch.remainder``)."""
    b = coords.to(torch.int32) >> block_shift
    p = [torch.tensor(c, dtype=torch.int32, device=coords.device) for c in _PRIMES]
    h = (b[..., 0] * p[0]) ^ (b[..., 1] * p[1]) ^ (b[..., 2] * p[2])
    return torch.remainder(torch.abs(h), n_devices)


def empty_sharded_map(capacity_per_shard: int, n_shards: int, device=None) -> vm.VoxelMap:
    """A ``VoxelMap`` with a leading shard axis ``(n_shards, ...)``; each
    shard's tensors are their own memory (no broadcast views)."""
    one = vm.empty_map(capacity_per_shard, device=device)
    return vm.VoxelMap(*(x.unsqueeze(0).repeat((n_shards,) + (1,) * x.dim()) for x in one))


def shard(smap: vm.VoxelMap, s: int) -> vm.VoxelMap:
    """The ``s``-th local shard as a plain ``VoxelMap``."""
    return vm.VoxelMap(*(x[s] for x in smap))


def _stack(maps) -> vm.VoxelMap:
    return vm.VoxelMap(*(torch.stack(leaves) for leaves in zip(*maps)))


def _check_layout(smap: vm.VoxelMap, mesh: Mesh) -> None:
    if smap.keys.dim() != 3 or smap.keys.shape[0] != mesh.local:
        raise ValueError(f"sharded map of {tuple(smap.keys.shape)} keys on a mesh holding "
                         f"{mesh.local} shards on this rank")


def insert(
    smap: vm.VoxelMap,
    cloud: PointCloud,
    resolution: float,
    mesh: Mesh,
    block_shift: int = BLOCK_SHIFT,
) -> vm.VoxelMap:
    """Occupancy-deduped insert into the owning shards (no collective)."""
    _check_layout(smap, mesh)
    coords = voxel_coords(cloud.points, resolution, cloud.mask)
    owner = owner_of(coords, mesh.size, block_shift)
    return _stack([
        vm.insert(shard(smap, s), PointCloud(cloud.points, cloud.mask & (owner == mesh.first + s)),
                  resolution)
        for s in range(mesh.local)
    ])


def approx_nn(
    smap: vm.VoxelMap,
    points: torch.Tensor,
    mask: torch.Tensor,
    resolution: float,
    mesh: Mesh,
    radius: int = 1,
) -> MapNNResult:
    """Approximate NN against the sharded map; the result is replicated."""
    _check_layout(smap, mesh)
    res = [vm.approx_nn(shard(smap, s), points, mask, resolution, radius=radius)
           for s in range(mesh.local)]
    d2 = torch.stack([r.dist2 for r in res])                 # (local, Q)
    found = torch.stack([r.found for r in res])
    pts = torch.stack([r.points for r in res])               # (local, Q, 3)
    # the global best distance; the lowest shard id wins a tie
    best_d2 = mesh.pmin(d2)
    is_winner = (d2 == best_d2[None]) & found
    ids = mesh.shard_ids()[:, None]
    win = mesh.pmin(torch.where(is_winner, ids, torch.full_like(ids, mesh.size)))
    final = is_winner & (ids == win[None])
    pts_out = mesh.psum(torch.where(final[..., None], pts, 0.0))
    found_out = mesh.psum(final.to(torch.int32)) > 0
    return MapNNResult(points=pts_out, dist2=torch.where(found_out, best_d2, float("inf")),
                       found=found_out)


def total_size(smap: vm.VoxelMap, mesh: Mesh | None = None) -> torch.Tensor:
    """Live voxels over all shards (int32); over the ranks too with a mesh."""
    if mesh is not None:
        return mesh.psum(smap.size)
    return smap.size.sum(dtype=torch.int32)


def total_overflow(smap: vm.VoxelMap, mesh: Mesh | None = None) -> torch.Tensor:
    if mesh is not None:
        return mesh.psum(smap.overflow)
    return smap.overflow.sum(dtype=torch.int32)


def reset(smap: vm.VoxelMap) -> vm.VoxelMap:
    n, cap = smap.keys.shape[0], smap.keys.shape[1]
    return empty_sharded_map(cap, n, device=smap.keys.device)
