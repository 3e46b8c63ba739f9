"""The probes' scan stream: the port's copy of the JAX package's
``bench._make_stream`` (a KITTI-like synthetic stream: a 40 m × 4 m room
of 200,000 points, a 12 m loop of half a lap, 30,000-point scans with
0.02 m noise, padded to ``max_raw_points``)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from icpslam_tpu_torch.cloud.pointcloud import PointCloud
from icpslam_tpu_torch.io import synthetic


def make_stream(cfg, n_scans: int, warmup: int, device) -> Tuple[List[PointCloud], Tuple[np.ndarray, np.ndarray]]:
    """``warmup + n_scans`` scans on ``device`` and the ground truth ``(t, q)``."""
    world = synthetic.make_room_world(seed=0, n_points=200000, size=40.0, height=4.0)
    gt = synthetic.make_loop_trajectory(n_poses=warmup + n_scans, radius=12.0, laps=0.5)
    scans = [
        PointCloud(torch.from_numpy(p).to(device), torch.from_numpy(m).to(device))
        for p, m in synthetic.scan_stream(
            world, gt, capacity=cfg.max_raw_points, max_range=25.0,
            n_points=30000, noise=0.02, seed=0,
        )
    ]
    return scans, gt


def pose_at(gt, i: int, device):
    """Ground-truth pose ``i`` as a ``Pose`` on ``device``."""
    from icpslam_tpu_torch.geometry.se3 import Pose

    return Pose(t=torch.from_numpy(gt[0][i]).to(device), q=torch.from_numpy(gt[1][i]).to(device))
