"""Checkpoint and resume (port of ``icpslam_tpu/utils/checkpoint.py``).

A checkpoint is the whole ``SlamState`` in a compressed numpy archive,
one entry per tensor, keyed by its path through the NamedTuples as JAX's
``jax.tree_util.keystr`` keys a pytree leaf (``.keyframes.pose_graph.t``,
``.map.size``, ...); None fields hold no entry, as in JAX. So a JAX
checkpoint loads into the port and the port's into JAX, leaf for leaf.
The map is derivable: ``rerender_map`` rebuilds it from the keyframe
clouds at their graph poses (the point map, the voxel map, or the
sharded map over its mesh, re-sharded by the same spatial hash).
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from icpslam_tpu_torch.cloud.pointcloud import PointCloud
from icpslam_tpu_torch.geometry import quaternion as quat
from icpslam_tpu_torch.geometry import se3
from icpslam_tpu_torch.mapping import backend as map_backend
from icpslam_tpu_torch.mapping import point_map as pm
from icpslam_tpu_torch.ops.linalg3 import rotate_sym3_comps


def leaves_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(keystr, tensor)`` for every tensor of a NamedTuple tree, in field
    order; None fields are skipped."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if tree is None:
        return []
    out = []
    for name in tree._fields:
        out.extend(leaves_with_paths(getattr(tree, name), f"{prefix}.{name}"))
    return out


def _rebuild(template: Any, values: Dict[str, torch.Tensor], prefix: str = "") -> Any:
    if isinstance(template, torch.Tensor):
        return values[prefix]
    if template is None:
        return None
    return type(template)(*(_rebuild(getattr(template, f), values, f"{prefix}.{f}")
                            for f in template._fields))


def save(path: str, tree: Any) -> None:
    """Write a NamedTuple tree of tensors to ``path`` (.npz)."""
    np.savez_compressed(path, **{k: v.detach().cpu().numpy() for k, v in leaves_with_paths(tree)})


def load(path: str, template: Any) -> Any:
    """Load a tree saved by ``save`` (or by the JAX package's): ``template``
    (``slam.init_state(config, device=...)``) gives the structure, the
    dtypes and the device. A shape other than the template's raises. A
    leaf missing from the file (a state field added after it was written)
    is taken from the template with a warning, as JAX does."""
    data = np.load(path)
    values = {}
    for key, tleaf in leaves_with_paths(template):
        if key not in data:
            warnings.warn(f"checkpoint {path} predates state leaf {key}; "
                          "defaulting it from the template")
            values[key] = tleaf
            continue
        arr = data[key]
        if tuple(arr.shape) != tuple(tleaf.shape):
            raise ValueError(f"checkpoint leaf {key} has shape {arr.shape}, "
                             f"config expects {tuple(tleaf.shape)}")
        want = tleaf.detach().cpu().numpy().dtype
        values[key] = torch.from_numpy(np.array(arr, dtype=want)).to(tleaf.device)
    return _rebuild(template, values)


def rerender_map(state, config, mesh=None):
    """The state with its map rebuilt from the keyframe clouds at their
    graph poses (used on resume). A plane-mode point map gets each
    keyframe's covariances rotated into the map frame, as JAX's does.
    ``mesh`` is required for ``map_backend='sharded'``: the rebuilt map is
    re-sharded by the same spatial hash."""
    from icpslam_tpu_torch.pipeline.odometry import compute_covariances

    store = state.keyframes
    n = int(store.count)
    m = map_backend.empty(config, device=store.points.device, mesh=mesh)
    with_covs = (
        isinstance(m, pm.PointMap)
        and config.icp_mapping.mode == "plane"
        and config.voxel_leaf_size >= config.map_resolution
    )
    for k in range(n):
        cloud = PointCloud(points=store.points[k], mask=store.point_mask[k])
        pose = se3.index(store.pose_graph, k)
        world = PointCloud(
            points=se3.transform_points(pose, cloud.points) * cloud.mask[:, None],
            mask=cloud.mask,
        )
        if with_covs:
            R = quat.to_matrix(pose.q)
            c6 = compute_covariances(cloud, config.icp_mapping)
            covs_w = torch.stack(rotate_sym3_comps(R, tuple(c6[i] for i in range(6))))
            nn, _ = pm.exact_nn_with_covs(m, world.points, world.mask)
            m = pm.insert_with_nn(m, world, config.map_resolution, nn.dist2, covs=covs_w,
                                  eviction=config.map_eviction)
        else:
            m = map_backend.insert(m, world, config.map_resolution, eviction=config.map_eviction,
                                   mesh=mesh)
    return state._replace(map=m)
