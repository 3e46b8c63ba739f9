"""ICP scan-to-scan odometry front-end (port of ``icpslam_tpu/pipeline/odometry.py``).

Voxel filter → GICP covariances (k-NN or radius) → ICP against the
previous cloud → accept gate → pose and accumulator update. The JAX ``lax.cond`` around the
registration becomes a host branch on ``do_register``, which the caller
passes in (it reads the state's flags once per scan). De-skew is not part
of the port yet and raises.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from icpslam_tpu_torch.cloud import pointcloud as pc
from icpslam_tpu_torch.cloud.voxel import voxel_downsample
from icpslam_tpu_torch.geometry import se3
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.ops import covariance as cov_ops
from icpslam_tpu_torch.ops import icp as icp_ops
from icpslam_tpu_torch.utils.device import resolve as resolve_device


def compute_covariances(cloud: pc.PointCloud, icfg) -> torch.Tensor:
    """Covariances for a cloud per the ICP config (radius or k-NN mode)."""
    if icfg.covariance_mode == "radius":
        return cov_ops.gicp_covariances_radius(
            cloud,
            radius=icfg.covariance_radius,
            epsilon=icfg.covariance_epsilon,
            sigma=icfg.covariance_sigma,
        )
    return cov_ops.gicp_covariances(
        cloud, k=icfg.covariance_knn, epsilon=icfg.covariance_epsilon
    )


class OdometryState(NamedTuple):
    initialized: torch.Tensor   # bool
    pose: Pose                  # accumulated odometry pose (odom frame)
    accum: Pose                 # relative-transform accumulator
    prev_cloud: pc.PointCloud   # last processed (filtered) cloud
    prev_covs: torch.Tensor     # (6, N) packed covariances of prev_cloud
    prev_u: torch.Tensor        # (N,) capture fractions (de-skew; zeros here)
    last_transform: Pose        # last accepted relative motion
    skip_count: torch.Tensor    # int32
    scan_count: torch.Tensor    # int32


class OdometryOutput(NamedTuple):
    pose: Pose
    transform: Pose
    processed: torch.Tensor
    accepted: torch.Tensor
    fitness: torch.Tensor
    num_correspondences: torch.Tensor
    iterations: torch.Tensor
    num_voxels: torch.Tensor
    filtered: pc.PointCloud
    filtered_covs: torch.Tensor
    hessian: torch.Tensor


def init_state(config, initial_pose: Pose | None = None, device=None) -> OdometryState:
    """The empty odometry state on ``device`` (default: the CUDA card;
    raises without one — pass ``device="cpu"`` for the CPU)."""
    device = resolve_device(device)
    if initial_pose is None:
        initial_pose = se3.identity(device=device)
    n = config.max_points
    return OdometryState(
        initialized=torch.tensor(False, device=device),
        pose=initial_pose,
        accum=se3.identity(device=device),
        prev_cloud=pc.empty(n, device=device),
        prev_covs=cov_ops.eye6(n, device=device),
        prev_u=torch.zeros((n,), device=device),
        last_transform=se3.identity(device=device),
        skip_count=torch.tensor(0, dtype=torch.int32, device=device),
        scan_count=torch.tensor(0, dtype=torch.int32, device=device),
    )


def set_initial_pose(state: OdometryState, pose: Pose) -> OdometryState:
    """Bootstrap from external (wheel) odometry."""
    return state._replace(pose=pose)


def check_supported(config) -> None:
    """Raise for the odometry options the port does not cover yet."""
    if config.deskew_rounds > 0:
        raise NotImplementedError(
            "in-loop de-skew (deskew_rounds > 0) is not ported yet — "
            "ROADMAP.md Queue 1, 'de-skew'"
        )


def odometry_step(
    state: OdometryState, raw_scan: pc.PointCloud, config, do_register: bool, skip: bool
) -> Tuple[OdometryState, OdometryOutput]:
    """Process one raw sensor-frame scan.

    ``do_register`` / ``skip`` are the host values of
    ``initialized & ~skip`` and ``initialized & skip_count > 0``.
    """
    check_supported(config)
    icfg = config.icp_odometry
    plane = icfg.mode == "plane"
    dev = raw_scan.points.device

    if config.has_laser_extrinsic:
        ext = Pose(
            t=torch.tensor(config.laser_extrinsic_t, dtype=torch.float32, device=dev),
            q=torch.tensor(config.laser_extrinsic_q, dtype=torch.float32, device=dev),
        )
        raw_scan = pc.transform(ext, raw_scan)

    filtered, num_voxels = voxel_downsample(raw_scan, config.voxel_leaf_size, config.max_points)
    covs = compute_covariances(filtered, icfg) if plane else state.prev_covs

    ident = se3.identity(device=dev)
    zeros66 = torch.zeros((6, 6), device=dev)
    if do_register:
        res = icp_ops.icp(
            filtered, state.prev_cloud, icfg,
            init=state.last_transform,
            source_covs=covs if plane else None,
            target_covs=state.prev_covs if plane else None,
            target_valid_len=state.prev_cloud.mask.sum(dtype=torch.int32),
            want_hessian=config.adaptive_information,
        )
        accepted = res.converged & (res.fitness < icfg.fitness_threshold)
        transform = se3.where(accepted, res.pose, ident)
        fitness, n_corr, iters = res.fitness, res.num_correspondences, res.iterations
        hessian = (
            res.hessian * accepted.to(torch.float32)
            if config.adaptive_information else zeros66
        )
    else:
        transform = ident
        accepted = torch.tensor(False, device=dev)
        fitness = torch.tensor(float("inf"), device=dev)
        n_corr = torch.tensor(0, dtype=torch.int32, device=dev)
        iters = torch.tensor(0, dtype=torch.int32, device=dev)
        hessian = zeros66

    new_pose = se3.normalize(se3.compose(state.pose, transform))
    new_accum = se3.normalize(se3.compose(state.accum, transform))

    take_cloud = ~state.initialized | (torch.tensor(do_register, device=dev) & accepted)
    new_prev_cloud = pc.PointCloud(
        points=torch.where(take_cloud, filtered.points, state.prev_cloud.points),
        mask=torch.where(take_cloud, filtered.mask, state.prev_cloud.mask),
    )
    new_prev_covs = torch.where(take_cloud, covs, state.prev_covs) if plane else state.prev_covs
    new_skip = (
        state.skip_count - 1 if skip
        else torch.tensor(config.num_clouds_skip, dtype=torch.int32, device=dev)
    )
    new_state = OdometryState(
        initialized=torch.tensor(True, device=dev),
        pose=new_pose,
        accum=new_accum,
        prev_cloud=new_prev_cloud,
        prev_covs=new_prev_covs,
        prev_u=state.prev_u,
        last_transform=se3.where(accepted, transform, state.last_transform),
        skip_count=new_skip,
        scan_count=state.scan_count + 1,
    )
    out = OdometryOutput(
        pose=new_pose,
        transform=transform,
        processed=torch.tensor(do_register, device=dev),
        accepted=accepted,
        fitness=fitness,
        num_correspondences=n_corr,
        iterations=iters,
        num_voxels=num_voxels,
        filtered=filtered,
        filtered_covs=covs,
        hessian=hessian,
    )
    return new_state, out
