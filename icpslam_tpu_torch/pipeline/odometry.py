"""ICP scan-to-scan odometry front-end (port of ``icpslam_tpu/pipeline/odometry.py``).

Voxel filter → GICP covariances (k-NN or radius) → ICP against the
previous cloud → accept gate → pose and accumulator update. The JAX ``lax.cond`` around the
registration becomes a host branch on ``do_register``. ``odometry_step``
takes JAX's contract, ``(state, scan, config)``, and then reads the
state's two flags in one counted host read; ``slam_step``, which reads
them with its other counters, passes them in. ``run_scans`` drives a
stacked chunk (JAX's ``lax.scan``) with one flag read per chunk, and
``drain_accumulator`` hands out the relative motion since the last drain
(the reference's ``getEstimates``).

With ``deskew_rounds > 0`` the step de-skews in the loop, without an INS,
in one of JAX's three modes (``deskew_mode``):

- ``'coupled'``: ``ops/skew_icp.coupled_deskew_icp`` registers the skewed
  filtered scan against the previous SKEWED filtered scan, warping both by
  the transform being solved (or the source by a freed twist). The state
  keeps the skewed cloud, its capture fractions (``prev_u``) and its
  covariances; mapping gets the scan de-skewed by the source twist, with
  the SKEWED covariances (JAX measured recomputed ones as worse: ATE
  0.50 m against 0.33 m over 500 poses).
- ``'joint'``: ``ops/skew_icp.skew_aware_icp`` against the previous clean
  cloud; the raw scan is then de-skewed by the estimated twist and
  filtered (and its covariances computed) a second time.
- ``'alternate'``: ``deskew_rounds`` rounds of warp by the current motion
  estimate, filter, covariances and ICP, seeded by the last transform.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from icpslam_tpu_torch.cloud import deskew as deskew_ops
from icpslam_tpu_torch.cloud import pointcloud as pc
from icpslam_tpu_torch.cloud.voxel import voxel_downsample
from icpslam_tpu_torch.geometry import se3
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.ops import covariance as cov_ops
from icpslam_tpu_torch.ops import icp as icp_ops
from icpslam_tpu_torch.ops import skew_icp
from icpslam_tpu_torch.utils import profiling, tree
from icpslam_tpu_torch.utils.device import resolve as resolve_device
from icpslam_tpu_torch.utils.sync import to_host


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
    prev_cloud: pc.PointCloud   # last processed (filtered) cloud; skewed in 'coupled' mode
    prev_covs: torch.Tensor     # (6, N) packed covariances of prev_cloud
    prev_u: torch.Tensor        # (N,) capture fractions of prev_cloud ('coupled'; zeros otherwise)
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


def drain_accumulator(state: OdometryState) -> Tuple[Pose, OdometryState]:
    """The relative transform accumulated since the last drain, and the
    state with the accumulator reset to identity (``getEstimates``,
    ``icp_odometer.cpp:82-94``)."""
    return state.accum, state._replace(accum=se3.identity(device=state.accum.t.device))


def host_flags(state: OdometryState) -> Tuple[bool, int]:
    """``(initialized, skip_count)`` in one counted host read."""
    initialized, skip_count = (int(v) for v in to_host(torch.stack([
        state.initialized.to(torch.int32), state.skip_count.to(torch.int32)])))
    return bool(initialized), skip_count


def registration_flags(initialized: bool, skip_count: int) -> Tuple[bool, bool]:
    """``(do_register, skip)`` from the flags, as JAX derives them."""
    skip = initialized and skip_count > 0
    return initialized and not skip, skip


def run_scans(
    state: OdometryState, scans: pc.PointCloud, config
) -> Tuple[OdometryState, OdometryOutput]:
    """A chunk of scans through :func:`odometry_step`: ``scans`` is a
    stacked cloud ``(T, N, 3)`` / ``(T, N)``; the outputs gain the leading
    axis (JAX's ``lax.scan`` contract). The flags are read once, at the
    chunk's start, and then stepped on the host as the step sets them
    (``initialized`` becomes true; ``skip_count`` counts down while
    skipping, else restarts at ``num_clouds_skip``), so the chunk launches
    exactly the kernels of one-by-one driving, in the same order."""
    initialized, skip_count = host_flags(state)
    outs = []
    for i in range(scans.points.shape[0]):
        do_register, skip = registration_flags(initialized, skip_count)
        state, out = odometry_step(state, pc.PointCloud(scans.points[i], scans.mask[i]), config,
                                   do_register, skip)
        outs.append(out)
        initialized, skip_count = True, skip_count - 1 if skip else config.num_clouds_skip
    return state, tree.stack(outs)


def check_supported(config) -> None:
    """Raise for odometry options outside JAX's set."""
    if config.deskew_rounds > 0 and config.deskew_mode not in ("coupled", "joint", "alternate"):
        raise ValueError(
            f"deskew_mode={config.deskew_mode!r}: expected 'coupled', 'joint' or 'alternate'"
        )


class _Registration(NamedTuple):
    transform: Pose
    accepted: torch.Tensor
    fitness: torch.Tensor
    num_correspondences: torch.Tensor
    iterations: torch.Tensor
    hessian: torch.Tensor


def _gate(res, icfg, config) -> _Registration:
    """The accept gate on a registration result (``converged`` and fitness)."""
    accepted = res.converged & (res.fitness < icfg.fitness_threshold)
    dev = accepted.device
    hessian = (
        res.hessian * accepted.to(torch.float32)
        if config.adaptive_information else torch.zeros((6, 6), device=dev)
    )
    return _Registration(
        transform=se3.where(accepted, res.pose, se3.identity(device=dev)),
        accepted=accepted, fitness=res.fitness,
        num_correspondences=res.num_correspondences, iterations=res.iterations,
        hessian=hessian,
    )


def _no_registration(dev) -> _Registration:
    return _Registration(
        transform=se3.identity(device=dev),
        accepted=torch.tensor(False, device=dev),
        fitness=torch.tensor(float("inf"), device=dev),
        num_correspondences=torch.tensor(0, dtype=torch.int32, device=dev),
        iterations=torch.tensor(0, dtype=torch.int32, device=dev),
        hessian=torch.zeros((6, 6), device=dev),
    )


def _masked(points: torch.Tensor, mask: torch.Tensor) -> pc.PointCloud:
    return pc.PointCloud(points=torch.where(mask[:, None], points, 0.0), mask=mask)


@profiling.spanned("odometry.step")
def odometry_step(
    state: OdometryState, raw_scan: pc.PointCloud, config,
    do_register: Optional[bool] = None, skip: Optional[bool] = None,
) -> Tuple[OdometryState, OdometryOutput]:
    """Process one raw sensor-frame scan.

    ``do_register`` / ``skip``: the host values of ``initialized & ~skip``
    and ``initialized & skip_count > 0``, from a caller that has read the
    state's flags already; without them the step reads the flags itself
    (one counted host read).
    """
    if do_register is None or skip is None:
        do_register, skip = registration_flags(*host_flags(state))
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

    def filter_and_covs(scan):
        with profiling.annotate("odometry.filter"):
            filtered, num_voxels = voxel_downsample(scan, config.voxel_leaf_size,
                                                    config.max_points)
            covs = compute_covariances(filtered, icfg) if plane else state.prev_covs
        return filtered, num_voxels, covs

    prev_len = state.prev_cloud.mask.sum(dtype=torch.int32)

    def register_icp(filtered, covs, init) -> _Registration:
        with profiling.annotate("odometry.register"):
            res = icp_ops.icp(
                filtered, state.prev_cloud, icfg,
                init=init,
                source_covs=covs if plane else None,
                target_covs=state.prev_covs if plane else None,
                target_valid_len=prev_len,
                want_hessian=config.adaptive_information,
            )
            return _gate(res, icfg, config)

    stash_cloud = stash_u = None
    mode = config.deskew_mode if config.deskew_rounds > 0 else None
    if mode == "coupled":
        filtered_s, num_voxels, covs = filter_and_covs(raw_scan)  # skewed
        u_f = deskew_ops.sweep_fraction(filtered_s.points)
        auto_prior = (
            (config.deskew_auto_straight_weight, config.deskew_prior_weight,
             config.deskew_auto_turn_threshold)
            if (config.deskew_free_twist and config.deskew_auto_prior) else None
        )
        cv_twist = se3.se3_log(state.last_transform)
        if do_register:
            with profiling.annotate("odometry.register"):
                res = skew_icp.coupled_deskew_icp(
                    filtered_s, state.prev_cloud, state.prev_u, icfg,
                    source_u=u_f, init=state.last_transform,
                    source_covs=covs if plane else None,
                    target_covs=state.prev_covs if plane else None,
                    target_valid_len=prev_len,
                    free_source_twist=config.deskew_free_twist,
                    source_twist_prior_weight=config.deskew_prior_weight,
                    prior_huber_delta=config.deskew_prior_huber,
                    auto_prior=auto_prior,
                    want_hessian=config.adaptive_information,
                )
                reg = _gate(res, icfg, config)
            src_twist = torch.where(reg.accepted, res.skew_twist, cv_twist)
        else:
            reg, src_twist = _no_registration(dev), cv_twist
        # mapping gets the scan de-skewed by its own sweep's twist, with
        # the skewed cloud's covariances (see the module docstring)
        filtered = _masked(
            deskew_ops.deskew_points(filtered_s.points, u_f, se3.se3_exp(src_twist)),
            filtered_s.mask,
        )
        stash_cloud, stash_u = filtered_s, u_f
    elif mode == "joint":
        u_raw = deskew_ops.sweep_fraction(raw_scan.points)
        filtered_s, _, covs_s = filter_and_covs(raw_scan)
        u_f = deskew_ops.sweep_fraction(filtered_s.points)
        cv_seed = se3.se3_log(state.last_transform)
        if do_register:
            with profiling.annotate("odometry.register"):
                res = skew_icp.skew_aware_icp(
                    filtered_s, state.prev_cloud, icfg, sweep_u=u_f,
                    init=state.last_transform, init_skew=cv_seed,
                    source_covs=covs_s if plane else None,
                    target_covs=state.prev_covs if plane else None,
                    target_valid_len=prev_len,
                    # JAX keeps the joint mode at its measured weight, 1.0
                    skew_prior_weight=1.0,
                    want_hessian=config.adaptive_information,
                )
                reg = _gate(res, icfg, config)
            skew_twist = torch.where(reg.accepted, res.skew_twist, cv_seed)
        else:
            reg, skew_twist = _no_registration(dev), cv_seed
        scan_d = _masked(
            deskew_ops.deskew_points(raw_scan.points, u_raw, se3.se3_exp(skew_twist)),
            raw_scan.mask,
        )
        filtered, num_voxels, covs = filter_and_covs(scan_d)
    elif mode == "alternate":
        u_raw = deskew_ops.sweep_fraction(raw_scan.points)
        rel = state.last_transform
        for _ in range(config.deskew_rounds):
            scan_k = _masked(deskew_ops.deskew_points(raw_scan.points, u_raw, rel), raw_scan.mask)
            filtered, num_voxels, covs = filter_and_covs(scan_k)
            reg = register_icp(filtered, covs, rel) if do_register else _no_registration(dev)
            rel = se3.where(reg.accepted, reg.transform, rel)
    else:
        filtered, num_voxels, covs = filter_and_covs(raw_scan)
        reg = (register_icp(filtered, covs, state.last_transform) if do_register
               else _no_registration(dev))

    transform, accepted = reg.transform, reg.accepted
    new_pose = se3.normalize(se3.compose(state.pose, transform))
    new_accum = se3.normalize(se3.compose(state.accum, transform))

    take_cloud = ~state.initialized | (torch.tensor(do_register, device=dev) & accepted)
    stash = stash_cloud if stash_cloud is not None else filtered
    new_prev_cloud = pc.PointCloud(
        points=torch.where(take_cloud, stash.points, state.prev_cloud.points),
        mask=torch.where(take_cloud, stash.mask, state.prev_cloud.mask),
    )
    new_prev_covs = torch.where(take_cloud, covs, state.prev_covs) if plane else state.prev_covs
    new_prev_u = (
        torch.where(take_cloud, stash_u, state.prev_u) if stash_u is not None else state.prev_u
    )
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
        prev_u=new_prev_u,
        last_transform=se3.where(accepted, transform, state.last_transform),
        skip_count=new_skip,
        scan_count=state.scan_count + 1,
    )
    out = OdometryOutput(
        pose=new_pose,
        transform=transform,
        processed=torch.tensor(do_register, device=dev),
        accepted=accepted,
        fitness=reg.fitness,
        num_correspondences=reg.num_correspondences,
        iterations=reg.iterations,
        num_voxels=num_voxels,
        filtered=filtered,
        filtered_covs=covs,
        hessian=reg.hessian,
    )
    return new_state, out
