"""Map-backend dispatch: 'point' (append-only, exact NN, stored
covariances) or 'voxel' (the sorted voxel array, approximate NN, no
stored covariances). The sharded map of the system under test has no
counterpart here: ``map_backend='sharded'`` raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from slamref.cloud.pointcloud import PointCloud
from slamref.mapping import point_map as pm
from slamref.mapping import voxel_map as vm

MapState = Union[pm.PointMap, vm.VoxelMap]


def check_supported(config) -> None:
    if config.map_backend not in ("point", "voxel", "sharded"):
        raise ValueError(f"map_backend={config.map_backend!r}: expected 'point', 'voxel' "
                         "or 'sharded'")


def empty(config, device=None, mesh=None) -> MapState:
    """The empty map of ``config.map_backend``."""
    check_supported(config)
    if config.map_backend == "point":
        return pm.empty_map(config.max_map_points, device=device)
    if config.map_backend == "sharded":
        raise ValueError("the reference has no sharded map")
    return vm.empty_map(config.max_map_points, device=device)


def reset(map_: MapState) -> MapState:
    if isinstance(map_, pm.PointMap):
        return pm.reset(map_)
    return vm.reset(map_)


def total_size(map_: MapState, mesh=None) -> torch.Tensor:
    """Live entries (int32)."""
    return map_.size


def total_overflow(map_: MapState, mesh=None) -> torch.Tensor:
    return map_.overflow


def insert(map_: MapState, cloud: PointCloud, resolution: float, covs=None, eviction="none",
           mesh=None):
    """``covs`` and ``eviction`` concern the point backend only; the voxel
    maps store no covariances and keep counted drops."""
    if isinstance(map_, pm.PointMap):
        return pm.insert(map_, cloud, resolution, covs=covs, eviction=eviction)
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


def query_nn(map_: MapState, points, mask, config, mesh: Optional[object] = None
             ) -> vm.MapNNResult:
    """The map's NN of each query: exact (K1) on the point map, approximate
    over the neighbouring voxels on the voxel and sharded maps."""
    if isinstance(map_, pm.PointMap):
        return pm.exact_nn(map_, points, mask)
    return vm.approx_nn(map_, points, mask, config.map_resolution, radius=config.map_nn_radius)


def query_nn_with_covs(map_: MapState, points, mask, config, prune_beyond=None,
                       mesh: Optional[object] = None):
    """``(MapNNResult, covs)``: the stored map-frame covariances (6, Q) of
    the point backend, None for the voxel maps (whose callers recompute
    them from the NN cloud)."""
    if isinstance(map_, pm.PointMap):
        return pm.exact_nn_with_covs(map_, points, mask, prune_beyond=prune_beyond)
    return query_nn(map_, points, mask, config, mesh=mesh), None
