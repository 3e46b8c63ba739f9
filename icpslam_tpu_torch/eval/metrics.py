"""Trajectory evaluation: ATE and RPE (port of ``icpslam_tpu/eval/metrics.py``).

Poses are ``Pose``s of (T,) tensors on any device; the arithmetic runs on
the host in float32 like the JAX version.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from icpslam_tpu_torch.geometry import se3
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.ops.kabsch import weighted_rigid_align


def _cpu(p: Pose) -> Pose:
    return Pose(t=p.t.detach().cpu().float(), q=p.q.detach().cpu().float())


def align_trajectories(est: Pose, gt: Pose) -> Pose:
    """Best SE(3) ``T`` aligning the estimate's positions to ground truth
    (``gt ≈ T ∘ est``), by weighted Kabsch on the position sequences."""
    n = est.t.shape[0]
    T, _ = weighted_rigid_align(est.t, gt.t, torch.ones(n, dtype=est.t.dtype, device=est.t.device))
    return T


def ate(est: Pose, gt: Pose, align: bool = True) -> Tuple[float, np.ndarray]:
    """Absolute trajectory error after SE(3) alignment: (rmse, per-frame)."""
    est, gt = _cpu(est), _cpu(gt)
    est_t = est.t
    if align:
        est_t = se3.transform_points(align_trajectories(est, gt), est.t)
    err = np.linalg.norm(est_t.numpy() - gt.t.numpy(), axis=-1)
    return float(np.sqrt(np.mean(err**2))), err


def rpe(est: Pose, gt: Pose, delta: int = 1) -> Tuple[float, float]:
    """Relative pose error over ``delta`` frames: (translation, rotation) rmse."""
    est, gt = _cpu(est), _cpu(gt)
    if est.t.shape[0] <= delta:
        raise ValueError("trajectory too short for requested delta")
    a, b = se3.index(est, slice(None, -delta)), se3.index(est, slice(delta, None))
    ga, gb = se3.index(gt, slice(None, -delta)), se3.index(gt, slice(delta, None))
    rel_est = se3.relative(a, b)
    rel_gt = se3.relative(ga, gb)
    err = se3.relative(rel_gt, rel_est)
    terr = np.linalg.norm(err.t.numpy(), axis=-1)
    rerr = se3.distance_rotation(rel_gt, rel_est).numpy()
    return float(np.sqrt(np.mean(terr**2))), float(np.sqrt(np.mean(rerr**2)))
