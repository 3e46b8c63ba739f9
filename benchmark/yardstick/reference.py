"""Run the plain reference (``benchmark/slamref``) over a sequence's
first scans, on the same inputs the system under test got: the same
scans, configuration values, initial pose and stamps. Nothing of the
system is imported or read.

``tf32`` turns on TF32 matrix products for the run: the precision
control, one step below the float32 with TF32 off that the configuration
states.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from slamref import config as ref_config
from slamref.cloud.pointcloud import PointCloud
from slamref.geometry.se3 import Pose
from slamref.pipeline import slam as ref_slam
from yardstick.traffic import pad


def _graph(state) -> tuple:
    kf = state.keyframes
    n = int(kf.count)
    return n, kf.pose_graph.t[:n].cpu().numpy(), kf.pose_graph.q[:n].cpu().numpy()


def replay(scans: Sequence[np.ndarray], slam: dict, init_t: np.ndarray, init_q: np.ndarray,
           rate_hz: float, device, graph_at: Sequence[int] = (),
           tf32: bool = False) -> Tuple[np.ndarray, Dict[int, tuple]]:
    """The (len(scans), 18) per-scan records of the reference's steps from
    a fresh state, and its graph after each step of ``graph_at``: {step:
    (keyframe count, their positions (count, 3), rotations (count, 4))}."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        cfg = ref_config.from_dict(slam)
        dev = torch.device(device)
        pose = Pose(t=torch.as_tensor(np.asarray(init_t, np.float32), device=dev),
                    q=torch.as_tensor(np.asarray(init_q, np.float32), device=dev))
        state = ref_slam.init_state(cfg, pose, device=dev)
        records, graphs, want = [], {}, set(graph_at)
        for i, pts in enumerate(scans):
            p, m = pad(pts, cfg.max_raw_points)
            cloud = PointCloud(torch.from_numpy(p).to(dev), torch.from_numpy(m).to(dev))
            state, out = ref_slam.slam_step(state, cloud, cfg, stamp=i / rate_hz)
            records.append(out.packed)
            if i + 1 in want:
                graphs[i + 1] = _graph(state)
        if not records:
            return np.zeros((0, 18), np.float32), graphs
        return torch.stack(records).cpu().numpy(), graphs
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
