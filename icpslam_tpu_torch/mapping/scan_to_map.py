"""Scan-to-map refinement and map growth (port of ``icpslam_tpu/mapping/scan_to_map.py``).

Transform the filtered scan with the raw odometry pose; an empty map is
just seeded. Otherwise query the map (the point map: kernel K1, stored
covariances gathered with the result; the voxel map: its approximate NN,
and the target covariances computed from the NN cloud in the robot frame,
kernel K2), register the scan against the NN cloud with
fixed correspondences, re-query and re-register while the correction is
large, and grow the map with the refined scan on success. The JAX
``map_empty`` ``cond`` and re-query ``while_loop`` become host branches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from icpslam_tpu_torch.cloud import pointcloud as pc
from icpslam_tpu_torch.geometry import quaternion as quat
from icpslam_tpu_torch.geometry import se3
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.mapping import backend as map_backend
from icpslam_tpu_torch.mapping import point_map as pm
from icpslam_tpu_torch.ops import icp as icp_ops
from icpslam_tpu_torch.ops.linalg3 import rotate_sym6
from icpslam_tpu_torch.utils.sync import to_host


class RefineResult(NamedTuple):
    success: torch.Tensor
    refined_pose: Pose
    correction: Pose
    fitness: torch.Tensor
    nn_found: torch.Tensor
    map: map_backend.MapState
    nn_points: torch.Tensor
    nn_mask: torch.Tensor
    hessian: torch.Tensor
    icp_iterations: torch.Tensor = None


def refine_and_grow(
    map_: map_backend.MapState,
    scan: pc.PointCloud,
    raw_pose: Pose,
    config,
    map_empty: bool,
    scan_covs: torch.Tensor | None = None,
    mesh=None,
) -> RefineResult:
    """Refine ``raw_pose`` against the map and grow the map with the scan.

    ``map_empty`` is the host value of ``map.size == 0``; ``mesh`` is the
    mesh of ``map_backend='sharded'`` (``parallel/mesh.py``).
    """
    icfg = config.icp_mapping
    res_m = config.map_resolution
    plane = icfg.mode == "plane"
    point_backend = isinstance(map_, pm.PointMap)
    store_covs = plane and point_backend
    aligned_insert = point_backend and config.voxel_leaf_size >= res_m
    dev = scan.points.device
    f32 = torch.float32
    zeros66 = torch.zeros((6, 6), device=dev)

    # local import: pipeline/odometry.py sits above this module
    from icpslam_tpu_torch.pipeline.odometry import compute_covariances

    if plane and scan_covs is None:
        scan_covs = compute_covariances(scan, icfg)

    if map_empty:
        cloud_in_map = pc.transform(raw_pose, scan)
        if store_covs and aligned_insert:
            grown = map_backend.insert_reusing_nn(
                map_, cloud_in_map, res_m,
                torch.full((scan.capacity,), float("inf"), device=dev),
                covs=rotate_sym6(scan_covs, quat.to_matrix(raw_pose.q)),
                eviction=config.map_eviction,
            )
        else:
            grown = map_backend.insert(
                map_, cloud_in_map, res_m, eviction=config.map_eviction, mesh=mesh
            )
        return RefineResult(
            success=torch.tensor(False, device=dev),
            refined_pose=raw_pose,
            correction=se3.identity(device=dev),
            fitness=torch.tensor(float("inf"), device=dev),
            nn_found=torch.tensor(0, dtype=torch.int32, device=dev),
            map=grown,
            nn_points=torch.zeros((scan.capacity, 3), device=dev),
            nn_mask=torch.zeros((scan.capacity,), dtype=torch.bool, device=dev),
            hessian=zeros66,
            icp_iterations=torch.tensor(0, dtype=torch.int32, device=dev),
        )

    prune = float(max(icfg.max_correspondence_distance, res_m) ** 2)

    def one_round(pose: Pose):
        in_map = pc.transform(pose, scan)
        nn, map_covs = map_backend.query_nn_with_covs(
            map_, in_map.points, in_map.mask, config, prune_beyond=prune, mesh=mesh
        )
        inv = se3.inverse(pose)
        nn_robot = pc.PointCloud(
            points=torch.where(
                nn.found[:, None], se3.transform_points(inv, nn.points), 0.0
            ),
            mask=nn.found,
        )
        kwargs = {}
        if plane:
            if map_covs is not None:
                # stored map-frame covariances into the robot frame: Rᵀ C R
                target_covs = rotate_sym6(map_covs, quat.to_matrix(pose.q).T)
            else:
                target_covs = compute_covariances(nn_robot, icfg)
            kwargs = dict(source_covs=scan_covs, target_covs=target_covs)
        res = icp_ops.icp(
            scan, nn_robot, icfg,
            fixed_correspondences=config.mapping_fixed_correspondences,
            want_hessian=config.adaptive_information,
            **kwargs,
        )
        return res, nn, nn_robot

    def res_hess(r):
        return r.hessian if config.adaptive_information else zeros66

    icp_res, nn, nn_robot = one_round(raw_pose)
    hess = res_hess(icp_res)
    success = icp_res.converged
    correction = se3.where(success, icp_res.pose, se3.identity(device=dev))
    refined = se3.normalize(se3.compose(raw_pose, correction))
    fitness = icp_res.fitness

    extra_rounds = (
        config.mapping_requery_rounds - 1 if config.mapping_fixed_correspondences else 0
    )
    if extra_rounds > 0:
        thresh = 0.1 * res_m
        n_scan = torch.clamp(scan.mask.to(f32).sum(), min=1.0)

        def corr_displacement(corr: Pose) -> torch.Tensor:
            moved = se3.transform_points(corr, scan.points)
            d = torch.linalg.norm(moved - scan.points, dim=-1)
            return torch.where(scan.mask, d, 0.0).sum() / n_scan

        pose, mag, rounds, ok = refined, corr_displacement(correction), 0, success
        nn_pts, nn_msk, nn_d2, nn_fnd = nn_robot.points, nn_robot.mask, nn.dist2, nn.found
        while rounds < extra_rounds:
            ok_h, mag_h = to_host(torch.stack([ok.to(f32), mag]))
            if not (ok_h > 0 and mag_h > thresh):
                break
            res2, nn2, nn_robot2 = one_round(pose)
            ok2 = res2.converged
            corr2 = se3.where(ok2, res2.pose, se3.identity(device=dev))
            pose = se3.normalize(se3.compose(pose, corr2))
            mag = corr_displacement(corr2) * ok2.to(f32)
            rounds += 1
            ok = ok | ok2
            fitness = torch.where(ok2, res2.fitness, fitness)
            nn_pts = torch.where(ok2, nn_robot2.points, nn_pts)
            nn_msk = torch.where(ok2, nn_robot2.mask, nn_msk)
            nn_d2 = torch.where(ok2, nn2.dist2, nn_d2)
            nn_fnd = torch.where(ok2, nn2.found, nn_fnd)
            hess = torch.where(ok2, res_hess(res2), hess)
        refined, success = pose, ok
        rel_final = se3.relative(raw_pose, refined)
        correction = se3.where(success, rel_final, se3.identity(device=dev))
        nn = nn._replace(dist2=nn_d2, found=nn_fnd)
        nn_robot = pc.PointCloud(points=nn_pts, mask=nn_msk)

    success_h = bool(to_host(success))
    if success_h:
        grow_cloud = pc.transform(refined, scan)
        grow_covs = (
            rotate_sym6(scan_covs, quat.to_matrix(refined.q))
            if store_covs and aligned_insert else None
        )
        if aligned_insert:
            final_map = map_backend.insert_reusing_nn(
                map_, grow_cloud, res_m, nn.dist2, covs=grow_covs,
                eviction=config.map_eviction, mesh=mesh,
            )
        else:
            final_map = map_backend.insert(
                map_, grow_cloud, res_m, eviction=config.map_eviction, mesh=mesh
            )
    else:
        final_map = map_
    return RefineResult(
        success=success,
        refined_pose=se3.where(success, refined, raw_pose),
        correction=correction,
        fitness=fitness,
        nn_found=nn.found.sum(dtype=torch.int32),
        map=final_map,
        nn_points=nn_robot.points,
        nn_mask=nn_robot.mask,
        hessian=hess * success.to(f32),
        icp_iterations=icp_res.iterations,
    )
