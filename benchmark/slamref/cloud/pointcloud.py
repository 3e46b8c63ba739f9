"""Fixed-capacity padded point clouds (port of ``icpslam_tpu/cloud/pointcloud.py``).

A cloud is a ``(capacity, 3)`` float tensor plus a ``(capacity,)`` bool
mask; padded entries are zeros.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from slamref.geometry.se3 import Pose, transform_points
from slamref.utils.device import resolve as resolve_device


class PointCloud(NamedTuple):
    points: torch.Tensor  # (N, 3)
    mask: torch.Tensor    # (N,) bool

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    def count(self) -> torch.Tensor:
        return self.mask.sum(-1, dtype=torch.int32)


def empty(capacity: int, dtype=torch.float32, device=None) -> PointCloud:
    return PointCloud(
        points=torch.zeros((capacity, 3), dtype=dtype, device=device),
        mask=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def from_points(points, capacity: Optional[int] = None, dtype=torch.float32,
                device=None) -> PointCloud:
    """Pad a host-side (n, 3) array into a fixed-capacity cloud on
    ``device`` (default: the CUDA card; raises without one — pass
    ``device="cpu"`` for the CPU). Raises past ``capacity``."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    capacity = n if capacity is None else capacity
    if n > capacity:
        raise ValueError(f"{n} points exceed capacity {capacity}")
    buf = np.zeros((capacity, 3), dtype=np.float32)
    buf[:n] = points
    mask = np.zeros((capacity,), dtype=bool)
    mask[:n] = True
    device = resolve_device(device)
    return PointCloud(points=torch.from_numpy(buf).to(device=device, dtype=dtype),
                      mask=torch.from_numpy(mask).to(device))


def to_numpy(cloud: PointCloud) -> np.ndarray:
    """The valid points as a host-side (n, 3) array."""
    return cloud.points.detach().cpu().numpy()[cloud.mask.detach().cpu().numpy()]


def transform(pose: Pose, cloud: PointCloud) -> PointCloud:
    """Rigidly transform a cloud; padding stays zeroed."""
    moved = transform_points(pose, cloud.points)
    return PointCloud(
        points=torch.where(cloud.mask[..., None], moved, torch.zeros_like(moved)),
        mask=cloud.mask,
    )


def masked_centroid(cloud: PointCloud) -> torch.Tensor:
    """Mean of the valid points ((..., 3); zeros for an empty cloud)."""
    w = cloud.mask.to(cloud.points.dtype)
    n = torch.clamp(w.sum(-1), min=1.0)
    return (cloud.points * w[..., None]).sum(-2) / n[..., None]
