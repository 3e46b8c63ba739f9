"""External (wheel / filtered) odometry ingestion (port of
``icpslam_tpu/pipeline/robot_odometry.py``).

Consumes an external odometry pose stream: the first pose is the offset
that every later pose is taken relative to, a pose history is kept gated
by a minimum displacement (``config.wheel_odom_pose_gate``), and the
latest covariance rides along for the wheel-odometry graph edges.
Everything stays on the device; nothing is read on the host.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from icpslam_tpu_torch.geometry import se3
from icpslam_tpu_torch.geometry.se3 import Pose


class RobotOdometryState(NamedTuple):
    initialized: torch.Tensor   # bool
    first_pose: Pose            # raw first pose (the offset)
    pose: Pose                  # latest offset-removed pose
    last_gated_pose: Pose       # last pose that passed the displacement gate
    covariance: torch.Tensor    # (6, 6) latest covariance
    num_poses: torch.Tensor     # int32 gated poses kept
    num_received: torch.Tensor  # int32 raw messages seen


class RobotOdometryOutput(NamedTuple):
    pose: Pose             # offset-removed pose
    gated: torch.Tensor    # bool: the displacement gate passed
    is_first: torch.Tensor  # bool


def init_state(device=None) -> RobotOdometryState:
    ident = se3.identity(device=device)
    return RobotOdometryState(
        initialized=torch.tensor(False, device=device),
        first_pose=ident,
        pose=ident,
        last_gated_pose=ident,
        covariance=torch.eye(6, device=device),
        num_poses=torch.tensor(0, dtype=torch.int32, device=device),
        num_received=torch.tensor(0, dtype=torch.int32, device=device),
    )


def robot_odometry_step(
    state: RobotOdometryState, raw_pose: Pose, config, covariance: torch.Tensor | None = None
) -> Tuple[RobotOdometryState, RobotOdometryOutput]:
    """Ingest one external odometry pose."""
    if covariance is None:
        covariance = state.covariance
    is_first = ~state.initialized
    first = se3.where(is_first, raw_pose, state.first_pose)
    pose = se3.normalize(se3.relative(first, raw_pose))
    moved = se3.distance_translation(pose, state.last_gated_pose)
    gated = is_first | (moved >= config.wheel_odom_pose_gate)
    new_state = RobotOdometryState(
        initialized=torch.ones_like(state.initialized),
        first_pose=first,
        pose=pose,
        last_gated_pose=se3.where(gated, pose, state.last_gated_pose),
        covariance=covariance,
        num_poses=state.num_poses + gated.to(torch.int32),
        num_received=state.num_received + 1,
    )
    return new_state, RobotOdometryOutput(pose=pose, gated=gated, is_first=is_first)
