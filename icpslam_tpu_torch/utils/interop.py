"""State carried across between the JAX package and the port.

The JAX side hands its state over as NamedTuples of numpy arrays
(``jax.tree_util.tree_map(np.asarray, state)``); :func:`state_from_numpy`
rebuilds the port's state from it by field name, and :func:`state_to_numpy`
goes the other way. This is how a test starts both packages from one
mid-mission state (non-empty map, keyframes and edges; the odometry's
skewed previous cloud and its capture fractions in coupled de-skew). The
map is a ``PointMap`` or a ``VoxelMap`` by its fields.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from icpslam_tpu_torch.cloud.pointcloud import PointCloud
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.graph.keyframes import KeyframeStore
from icpslam_tpu_torch.graph.pose_graph import EdgeSet
from icpslam_tpu_torch.mapping.point_map import PointMap
from icpslam_tpu_torch.mapping.voxel_map import VoxelMap
from icpslam_tpu_torch.pipeline.odometry import OdometryState
from icpslam_tpu_torch.pipeline.robot_odometry import RobotOdometryState
from icpslam_tpu_torch.pipeline.slam import SlamState
from icpslam_tpu_torch.utils.device import resolve as resolve_device

# the port's NamedTuple type for each field that holds one
_FIELD_TYPES = {
    SlamState: {
        "odom": OdometryState, "robot_odom": RobotOdometryState,
        "wheel_at_last_kf": Pose, "map": None, "keyframes": KeyframeStore,  # map: by _map_type
        "edges": EdgeSet, "map_to_odom": Pose, "slam_pose": Pose,
    },
    OdometryState: {
        "pose": Pose, "accum": Pose, "prev_cloud": PointCloud, "last_transform": Pose,
    },
    RobotOdometryState: {"first_pose": Pose, "pose": Pose, "last_gated_pose": Pose},
    KeyframeStore: {"pose_odom": Pose, "pose_graph": Pose},
    PointMap: {}, VoxelMap: {}, EdgeSet: {}, Pose: {}, PointCloud: {},
}


def _map_type(tree):
    return VoxelMap if "keys" in tree._fields else PointMap


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def _build(cls, tree, device):
    kwargs = {}
    sub = _FIELD_TYPES[cls]
    for name in cls._fields:
        value = getattr(tree, name)
        if name in sub:
            kwargs[name] = _build(sub[name] or _map_type(value), value, device)
        else:
            kwargs[name] = _to_tensor(value, device)
    return cls(**kwargs)


def state_from_numpy(tree: Any, device=None, cls=SlamState):
    """The port's ``SlamState`` (or another of its state types, ``cls``,
    e.g. ``OdometryState``) from the JAX state as NamedTuples of numpy
    arrays, matched field by field by name (point or voxel map), on
    ``device`` (default: the CUDA card; raises without one)."""
    return _build(cls, tree, resolve_device(device))


def state_to_numpy(state: Any) -> Any:
    """The same NamedTuple structure with every tensor as a numpy array."""
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy()
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(state_to_numpy(v) for v in state))
    return state
