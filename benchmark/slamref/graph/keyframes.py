"""Fixed-capacity keyframe store (port of ``icpslam_tpu/graph/keyframes.py``)."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from slamref.cloud import pointcloud as pc
from slamref.geometry import se3
from slamref.geometry.se3 import Pose


class KeyframeStore(NamedTuple):
    pose_odom: Pose          # (K,) pose in odom frame at creation
    pose_graph: Pose         # (K,) current graph (map-frame) estimate
    stamp: torch.Tensor      # (K,) float32
    points: torch.Tensor     # (K, N, 3) keyframe clouds
    point_mask: torch.Tensor  # (K, N) bool
    cov: torch.Tensor        # (K, 6, 6) measurement covariance per keyframe
    count: torch.Tensor      # int32 live keyframes
    evictions: torch.Tensor  # int32 keyframes marginalized out

    @property
    def capacity(self) -> int:
        return self.stamp.shape[0]

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.stamp.device) < self.count


def empty(capacity: int, cloud_capacity: int, dtype=torch.float32, device=None) -> KeyframeStore:
    return KeyframeStore(
        pose_odom=se3.identity((capacity,), dtype, device),
        pose_graph=se3.identity((capacity,), dtype, device),
        stamp=torch.zeros((capacity,), dtype=dtype, device=device),
        points=torch.zeros((capacity, cloud_capacity, 3), dtype=dtype, device=device),
        point_mask=torch.zeros((capacity, cloud_capacity), dtype=torch.bool, device=device),
        cov=torch.zeros((capacity, 6, 6), dtype=dtype, device=device),
        count=torch.tensor(0, dtype=torch.int32, device=device),
        evictions=torch.tensor(0, dtype=torch.int32, device=device),
    )


def add(
    store: KeyframeStore,
    pose_odom: Pose,
    pose_graph: Pose,
    cloud: pc.PointCloud,
    stamp: torch.Tensor,
    cov: torch.Tensor | None = None,
) -> Tuple[KeyframeStore, torch.Tensor]:
    """Append a keyframe; returns ``(store, index)``. At capacity the write
    is dropped and ``count`` stops growing, as in the JAX version."""
    idx = torch.clamp(store.count, max=store.capacity - 1).long()
    full = store.count >= store.capacity
    if cov is None:
        cov = torch.zeros((6, 6), dtype=store.cov.dtype, device=store.cov.device)

    def upd(arr, val):
        return torch.where(full, arr, arr.index_copy(0, idx[None], val[None].to(arr.dtype)))

    new = KeyframeStore(
        pose_odom=Pose(t=upd(store.pose_odom.t, pose_odom.t), q=upd(store.pose_odom.q, pose_odom.q)),
        pose_graph=Pose(t=upd(store.pose_graph.t, pose_graph.t), q=upd(store.pose_graph.q, pose_graph.q)),
        stamp=upd(store.stamp, stamp),
        points=upd(store.points, cloud.points),
        point_mask=upd(store.point_mask, cloud.mask),
        cov=upd(store.cov, cov),
        count=torch.where(full, store.count, store.count + 1),
        evictions=store.evictions,
    )
    return new, idx.to(torch.int32)


def latest(store: KeyframeStore) -> Pose:
    idx = torch.clamp(store.count - 1, min=0).long()
    return Pose(t=store.pose_graph.t[idx], q=store.pose_graph.q[idx])


def latest_odom(store: KeyframeStore) -> Pose:
    idx = torch.clamp(store.count - 1, min=0).long()
    return Pose(t=store.pose_odom.t[idx], q=store.pose_odom.q[idx])


def set_graph_poses(store: KeyframeStore, poses: Pose) -> KeyframeStore:
    m = store.valid_mask()[:, None]
    return store._replace(
        pose_graph=Pose(
            t=torch.where(m, poses.t, store.pose_graph.t),
            q=torch.where(m, poses.q, store.pose_graph.q),
        )
    )
