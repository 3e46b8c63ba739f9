"""Batched multi-shard SLAM step: registration of a batch of scan pairs and
the distributed graph solve (port of ``icpslam_tpu/parallel/dist_step.py``).

The offline counterpart of the streaming ``pipeline/slam.py`` loop:

1. a batch of B consecutive scan *pairs* is cut over the ranks, and each
   rank registers its pairs with ``ops/icp.icp`` (kernel K1 in every
   iteration; plane mode takes its GICP covariances from
   ``pipeline/odometry.compute_covariances``, kernel K2), one pair after
   another as the port's loop closure verifies its candidates; the ranks'
   relative poses are gathered;
2. the relative poses are chained into a trajectory (a sequential
   compose on the device, where JAX runs a parallel prefix);
3. sequential graph edges are built from them and the graph is solved by
   the edge-sharded Gauss-Newton of ``parallel/dist_graph.py``.

``__graft_entry__.dryrun_multichip`` drives JAX's with the map built and
queried too (:func:`batched_slam_step_with_map`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from icpslam_tpu_torch.cloud.pointcloud import PointCloud
from icpslam_tpu_torch.geometry import se3
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.graph import pose_graph as pg
from icpslam_tpu_torch.ops import icp as icp_ops
from icpslam_tpu_torch.parallel import dist_graph
from icpslam_tpu_torch.parallel import sharded_map as sm
from icpslam_tpu_torch.parallel.mesh import Mesh


class BatchSlamResult(NamedTuple):
    nodes: Pose              # (B+1,) optimized trajectory
    rel_poses: Pose          # (B,) pairwise registrations
    fitness: torch.Tensor    # (B,)
    final_cost: torch.Tensor


def chain_poses(rel: Pose, base: Pose) -> Pose:
    """Integrate relative poses into absolute ones: ``nodes[k] = base ∘
    rel[0] ∘ … ∘ rel[k-1]``, (B+1,) poses. The prefix ``rel[0] ∘ … ∘
    rel[k-1]`` is composed first and ``base`` applied to it, as JAX's
    associative scan does; the prefix runs in sequence, so its rounding
    differs from JAX's tree order in the last bits."""
    t, q = [base.t], [base.q]
    prefix = None
    for k in range(rel.t.shape[0]):
        r = se3.index(rel, k)
        prefix = r if prefix is None else se3.compose(prefix, r)
        node = se3.compose(base, prefix)
        t.append(node.t)
        q.append(node.q)
    return Pose(t=torch.stack(t), q=torch.stack(q))


def sequential_edges(rel: Pose, info_diag: float = 100.0) -> pg.EdgeSet:
    """The B edges ``k → k+1`` of a chain of relative poses, all valid,
    with information ``info_diag · I``."""
    B, dev = rel.t.shape[0], rel.t.device
    return pg.EdgeSet(
        i=torch.arange(B, dtype=torch.int32, device=dev),
        j=torch.arange(1, B + 1, dtype=torch.int32, device=dev),
        rel_t=rel.t,
        rel_q=rel.q,
        info=(info_diag * torch.eye(6, device=dev)).expand(B, 6, 6).contiguous(),
        valid=torch.ones((B,), dtype=torch.bool, device=dev),
        count=torch.full((), B, dtype=torch.int32, device=dev),
        overflow=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _register(src: PointCloud, tgt: PointCloud, icp_config):
    kwargs = {}
    if icp_config.mode == "plane":
        # local import: pipeline/ sits above parallel/
        from icpslam_tpu_torch.pipeline.odometry import compute_covariances

        kwargs = dict(source_covs=compute_covariances(src, icp_config),
                      target_covs=compute_covariances(tgt, icp_config))
    return icp_ops.icp(src, tgt, icp_config, **kwargs)


def batched_slam_step(
    src: PointCloud,        # (B, N, 3) / (B, N) source scans
    tgt: PointCloud,        # (B, N, 3) / (B, N) target scans
    icp_config,
    mesh: Mesh,
    info_diag: float = 100.0,
    solver_iterations: int = 5,
) -> BatchSlamResult:
    """One batch step: every rank registers ``ceil(B / W)`` pairs (the
    last rank fewer), the results are gathered, chained, and the
    sequential graph solved by ``dist_graph.optimize`` in GN mode."""
    B = src.points.shape[0]
    dev = src.points.device
    per = -(-B // mesh.world)
    rows = range(mesh.rank * per, min(B, (mesh.rank + 1) * per))
    ident = se3.identity(device=dev)
    t, q, fit = [], [], []
    for b in rows:
        res = _register(PointCloud(src.points[b], src.mask[b]),
                        PointCloud(tgt.points[b], tgt.mask[b]), icp_config)
        t.append(res.pose.t)
        q.append(res.pose.q)
        fit.append(res.fitness.to(torch.float32))
    for _ in range(per - len(rows)):   # the last rank's padding rows
        t.append(ident.t)
        q.append(ident.q)
        fit.append(torch.zeros((), device=dev))
    rel = Pose(t=mesh.all_gather_tiled(torch.stack(t))[:B],
               q=mesh.all_gather_tiled(torch.stack(q))[:B])
    fitness = mesh.all_gather_tiled(torch.stack(fit))[:B]

    node_mask = torch.ones((B + 1,), dtype=torch.bool, device=dev)
    opt, stats = dist_graph.optimize(chain_poses(rel, ident), sequential_edges(rel, info_diag),
                                     node_mask, mesh, iterations=solver_iterations, mode="gn")
    return BatchSlamResult(nodes=opt, rel_poses=rel, fitness=fitness,
                           final_cost=stats.final_cost)


def batched_slam_step_with_map(
    src: PointCloud,
    tgt: PointCloud,
    icp_config,
    mesh: Mesh,
    map_resolution: float = 0.3,
    map_capacity_per_shard: int = 1024,
):
    """The batch step, then the spatially sharded map: every source scan
    goes into it at its optimized pose in one flattened insert (no
    collective), and the first scan is queried back (the pmin/psum
    reduction). Returns ``(result, map, nn)``."""
    result = batched_slam_step(src, tgt, icp_config, mesh)
    smap = sm.empty_sharded_map(map_capacity_per_shard, mesh.local, device=src.points.device)
    B, N = src.points.shape[:2]
    poses = Pose(t=result.nodes.t[1:], q=result.nodes.q[1:])
    world = se3.transform_points(poses, src.points)          # (B, N, 3)
    smap = sm.insert(smap, PointCloud(world.reshape(B * N, 3), src.mask.reshape(B * N)),
                     map_resolution, mesh)
    first = se3.transform_points(se3.index(result.nodes, 1), src.points[0])
    nn = sm.approx_nn(smap, first, src.mask[0], map_resolution, mesh)
    return result, smap, nn


def make_batched_step(icp_config, mesh: Mesh):
    """``step(src_pts, src_mask, tgt_pts, tgt_mask)`` → :func:`batched_slam_step`
    on the mesh (JAX's jitted step with its inputs placed on the mesh; here
    every rank takes the whole batch and registers its own pairs)."""
    def step(src_pts, src_mask, tgt_pts, tgt_mask):
        return batched_slam_step(PointCloud(src_pts, src_mask), PointCloud(tgt_pts, tgt_mask),
                                 icp_config, mesh)

    return step
