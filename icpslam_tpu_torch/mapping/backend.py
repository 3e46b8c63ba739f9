"""Map-backend dispatch (port of ``icpslam_tpu/mapping/backend.py``):
'point' (append-only, exact NN through K1, stored covariances), 'voxel'
(the sorted voxel array, approximate NN, no stored covariances) or
'sharded' (the voxel map spatially sharded over a mesh,
``parallel/sharded_map.py``).

The choice is ``config.map_backend``; the state holds whichever map it
selects, and each operation dispatches on the map's type. The sharded
map is a ``VoxelMap`` whose leaves carry a leading shard axis; its
operations take the ``mesh`` the step runs on, and each shard's capacity
is ``max_map_points``, so the total grows with the shards.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from icpslam_tpu_torch.cloud.pointcloud import PointCloud
from icpslam_tpu_torch.mapping import point_map as pm
from icpslam_tpu_torch.mapping import voxel_map as vm
from icpslam_tpu_torch.parallel import sharded_map as sm

MapState = Union[pm.PointMap, vm.VoxelMap]


def check_supported(config) -> None:
    if config.map_backend not in ("point", "voxel", "sharded"):
        raise ValueError(f"map_backend={config.map_backend!r}: expected 'point', 'voxel' "
                         "or 'sharded'")


def is_sharded(map_: MapState) -> bool:
    """Sharded maps are ``VoxelMap``s with a leading shard axis."""
    return isinstance(map_, vm.VoxelMap) and map_.keys.dim() == 3


def _need_mesh(mesh):
    if mesh is None:
        raise ValueError("sharded map ops need the mesh")
    return mesh


def empty(config, device=None, mesh=None) -> MapState:
    """The empty map of ``config.map_backend``. The sharded map has
    ``config.map_shards`` shards, or this rank's ``mesh.local`` of them
    when a mesh is given."""
    check_supported(config)
    if config.map_backend == "point":
        return pm.empty_map(config.max_map_points, device=device)
    if config.map_backend == "sharded":
        n = config.map_shards if mesh is None else mesh.local
        return sm.empty_sharded_map(config.max_map_points, n, device=device)
    return vm.empty_map(config.max_map_points, device=device)


def reset(map_: MapState) -> MapState:
    if isinstance(map_, pm.PointMap):
        return pm.reset(map_)
    return sm.reset(map_) if is_sharded(map_) else vm.reset(map_)


def total_size(map_: MapState, mesh=None) -> torch.Tensor:
    """Live entries (int32), summed over the shards of a sharded map (and
    over the ranks, given the mesh)."""
    return sm.total_size(map_, mesh) if is_sharded(map_) else map_.size


def total_overflow(map_: MapState, mesh=None) -> torch.Tensor:
    return sm.total_overflow(map_, mesh) if is_sharded(map_) else map_.overflow


def insert(map_: MapState, cloud: PointCloud, resolution: float, covs=None, eviction="none",
           mesh=None):
    """``covs`` and ``eviction`` concern the point backend only; the voxel
    maps store no covariances and keep counted drops."""
    if isinstance(map_, pm.PointMap):
        return pm.insert(map_, cloud, resolution, covs=covs, eviction=eviction)
    if is_sharded(map_):
        return sm.insert(map_, cloud, resolution, _need_mesh(mesh))
    return vm.insert(map_, cloud, resolution)


def insert_reusing_nn(
    map_: MapState, cloud: PointCloud, resolution: float, nn_dist2: torch.Tensor,
    covs=None, eviction="none", mesh=None,
):
    """Insert with the scan's NN distances to the map; the voxel maps
    rebuild their sorted index anyway, so there it is the plain insert."""
    if isinstance(map_, pm.PointMap):
        return pm.insert_with_nn(map_, cloud, resolution, nn_dist2, covs=covs, eviction=eviction)
    return insert(map_, cloud, resolution, mesh=mesh)


def query_nn_with_covs(map_: MapState, points, mask, config, prune_beyond=None,
                       mesh: Optional[object] = None):
    """``(MapNNResult, covs)``: the stored map-frame covariances (6, Q) of
    the point backend, None for the voxel maps (whose callers recompute
    them from the NN cloud)."""
    if isinstance(map_, pm.PointMap):
        return pm.exact_nn_with_covs(map_, points, mask, prune_beyond=prune_beyond)
    if is_sharded(map_):
        nn = sm.approx_nn(map_, points, mask, config.map_resolution, _need_mesh(mesh),
                          radius=config.map_nn_radius)
    else:
        nn = vm.approx_nn(map_, points, mask, config.map_resolution, radius=config.map_nn_radius)
    return nn, None
