"""Map-backend dispatch (port of ``icpslam_tpu/mapping/backend.py``):
'point' (append-only, exact NN through K1, stored covariances) or
'voxel' (the sorted voxel array, approximate NN, no stored covariances).

The choice is ``config.map_backend``; the state holds whichever map it
selects, and each operation dispatches on the map's type. ``'sharded'``
raises until ``parallel/`` is ported.
"""

from __future__ import annotations

from typing import Union

import torch

from icpslam_tpu_torch.cloud.pointcloud import PointCloud
from icpslam_tpu_torch.mapping import point_map as pm
from icpslam_tpu_torch.mapping import voxel_map as vm

MapState = Union[pm.PointMap, vm.VoxelMap]


def check_supported(config) -> None:
    if config.map_backend not in ("point", "voxel"):
        raise NotImplementedError(
            f"map_backend='{config.map_backend}' is not ported yet — "
            "ROADMAP.md Queue 1 item 7, 'parallel/' (the sharded map)"
        )


def empty(config, device=None) -> MapState:
    check_supported(config)
    if config.map_backend == "point":
        return pm.empty_map(config.max_map_points, device=device)
    return vm.empty_map(config.max_map_points, device=device)


def reset(map_: MapState) -> MapState:
    return pm.reset(map_) if isinstance(map_, pm.PointMap) else vm.reset(map_)


def total_size(map_: MapState) -> torch.Tensor:
    return map_.size


def total_overflow(map_: MapState) -> torch.Tensor:
    return map_.overflow


def insert(map_: MapState, cloud: PointCloud, resolution: float, covs=None, eviction="none"):
    """``covs`` and ``eviction`` concern the point backend only; the voxel
    map stores no covariances and keeps counted drops."""
    if isinstance(map_, pm.PointMap):
        return pm.insert(map_, cloud, resolution, covs=covs, eviction=eviction)
    return vm.insert(map_, cloud, resolution)


def insert_reusing_nn(
    map_: MapState, cloud: PointCloud, resolution: float, nn_dist2: torch.Tensor,
    covs=None, eviction="none",
):
    """Insert with the scan's NN distances to the map; the voxel map
    rebuilds its sorted index anyway, so there it is the plain insert."""
    if isinstance(map_, pm.PointMap):
        return pm.insert_with_nn(map_, cloud, resolution, nn_dist2, covs=covs, eviction=eviction)
    return vm.insert(map_, cloud, resolution)


def query_nn_with_covs(map_: MapState, points, mask, config, prune_beyond=None):
    """``(MapNNResult, covs)``: the stored map-frame covariances (6, Q) of
    the point backend, None for the voxel map (whose callers recompute
    them from the NN cloud)."""
    if isinstance(map_, pm.PointMap):
        return pm.exact_nn_with_covs(map_, points, mask, prune_beyond=prune_beyond)
    nn = vm.approx_nn(map_, points, mask, config.map_resolution, radius=config.map_nn_radius)
    return nn, None
