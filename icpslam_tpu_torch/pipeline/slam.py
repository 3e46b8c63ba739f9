"""Full SLAM step: odometry → scan-to-map → keyframes → pose graph (port of
``icpslam_tpu/pipeline/slam.py``).

``state, out = slam_step(state, scan, config)`` keeps the JAX contract:
the same ``SlamState`` / ``SlamOutput`` fields and the packed (18,) per-scan
record. The JAX ``lax.cond``s around refinement, the keyframe branch and
the optimization (``slam.py:536,657,677``) become host branches: the step
reads the state's small counters once at its start and a few flags as it
goes, each through the counted :func:`~icpslam_tpu_torch.utils.sync.to_host`.

Parts of the JAX step that are not ported yet raise ``NotImplementedError``
naming their ROADMAP item instead of doing something else: de-skew, the
voxel and sharded maps, marginalization at a full keyframe store,
PCG/Schur/dist-* solvers, wheel-odometry edges and the deferred solve.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from icpslam_tpu_torch.cloud import pointcloud as pc
from icpslam_tpu_torch.geometry import se3
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.graph import keyframes as kf
from icpslam_tpu_torch.graph import pose_graph as pg
from icpslam_tpu_torch.mapping import backend as map_backend
from icpslam_tpu_torch.mapping import scan_to_map
from icpslam_tpu_torch.ops import icp as icp_ops
from icpslam_tpu_torch.pipeline import odometry as odo
from icpslam_tpu_torch.pipeline import robot_odometry as robot_odo
from icpslam_tpu_torch.utils.device import resolve as resolve_device
from icpslam_tpu_torch.utils.sync import to_host


class SlamState(NamedTuple):
    odom: odo.OdometryState
    robot_odom: robot_odo.RobotOdometryState
    wheel_at_last_kf: Pose
    wheel_kf_valid: torch.Tensor
    map: map_backend.MapState
    keyframes: kf.KeyframeStore
    edges: pg.EdgeSet
    map_to_odom: Pose
    slam_pose: Pose
    kf_since_opt: torch.Tensor
    lc_since_opt: torch.Tensor
    num_optimizations: torch.Tensor
    num_loop_closures: torch.Tensor
    stamp: torch.Tensor


class SlamOutput(NamedTuple):
    odom_out: odo.OdometryOutput
    pose_map: Pose
    refined: torch.Tensor
    new_keyframe: torch.Tensor
    keyframe_index: torch.Tensor
    loop_closure: torch.Tensor
    optimized: torch.Tensor
    graph_cost: torch.Tensor
    map_size: torch.Tensor
    num_keyframes: torch.Tensor
    pose_cov: torch.Tensor = None
    packed: torch.Tensor = None  # (18,) [pose.t | pose.q | accepted, fitness,
    # n_corr, icp_iters, refined, new_keyframe, loop_closure, optimized,
    # map_size, num_keyframes, graph_cost]


def check_supported(config) -> None:
    """Raise ``NotImplementedError`` for configurations outside the port."""
    odo.check_supported(config)
    map_backend.check_supported(config)
    if config.enable_wheel_odom_edges:
        raise NotImplementedError(
            "wheel-odometry edges are not ported yet — ROADMAP.md Queue 1, 'wheel odometry'"
        )
    if config.defer_optimization:
        raise NotImplementedError(
            "defer_optimization is not ported yet — ROADMAP.md Queue 1, "
            "'Schur and the deferred solve'"
        )
    if config.graph_linear_solver not in ("auto", "direct"):
        raise pg._not_ported(config.graph_linear_solver)
    if config.collect_debug:
        raise NotImplementedError(
            "collect_debug is not ported yet — ROADMAP.md Queue 1, "
            "'the full runner and prefetch'"
        )


def init_state(config, initial_pose: Optional[Pose] = None, device=None) -> SlamState:
    """The empty SLAM state on ``device`` (default: the CUDA card; raises
    without one — pass ``device="cpu"`` for the CPU)."""
    check_supported(config)
    device = resolve_device(device)
    i32 = torch.int32
    return SlamState(
        odom=odo.init_state(config, initial_pose, device=device),
        robot_odom=robot_odo.init_state(device=device),
        wheel_at_last_kf=se3.identity(device=device),
        wheel_kf_valid=torch.tensor(False, device=device),
        map=map_backend.empty(config, device=device),
        keyframes=kf.empty(config.max_keyframes, config.max_points, device=device),
        edges=pg.empty_edges(config.max_edges, device=device),
        map_to_odom=se3.identity(device=device),
        slam_pose=initial_pose if initial_pose is not None else se3.identity(device=device),
        kf_since_opt=torch.tensor(0, dtype=i32, device=device),
        lc_since_opt=torch.tensor(0, dtype=i32, device=device),
        num_optimizations=torch.tensor(0, dtype=i32, device=device),
        num_loop_closures=torch.tensor(0, dtype=i32, device=device),
        stamp=torch.tensor(0.0, device=device),
    )


def _information(diag, device) -> torch.Tensor:
    return torch.diag(torch.tensor(diag, dtype=torch.float32, device=device))


def _adaptive_information(H: torch.Tensor, diag) -> torch.Tensor:
    """Edge information from the registration's GN Hessian, rescaled block
    by block to the configured diagonals (see the JAX docstring)."""
    fixed = _information(diag, H.device)
    d = torch.tensor(diag, dtype=torch.float32, device=H.device)
    t_tgt, r_tgt = d[:3].mean(), d[3:].mean()
    sym = 0.5 * (H + H.T)
    t_tr = torch.diagonal(sym[:3, :3]).sum() / 3.0
    r_tr = torch.diagonal(sym[3:, 3:]).sum() / 3.0
    ok = (t_tr > 1e-6) & (r_tr > 1e-6) & torch.isfinite(H).all()
    s_t = torch.sqrt(t_tgt / torch.clamp(t_tr, min=1e-6))
    s_r = torch.sqrt(r_tgt / torch.clamp(r_tr, min=1e-6))
    s = torch.cat([s_t.expand(3), s_r.expand(3)])
    sym = sym * s[:, None] * s[None, :]
    sym = sym + 1e-3 * torch.minimum(t_tgt, r_tgt) * torch.eye(6, device=H.device)
    return torch.where(ok, sym, fixed)


def _try_loop_closure(
    state: SlamState, new_idx: int, new_pose_graph: Pose, config
) -> Tuple[pg.EdgeSet, int]:
    """Propose the top-k older keyframes within radius and verify each by
    ICP between the stored clouds. A Python loop over the candidates gives
    the per-candidate results of the JAX ``vmap``; out-of-radius
    candidates are skipped instead of computed and gated out."""
    import dataclasses

    store = state.keyframes
    dev = store.points.device
    K = store.capacity
    ids = torch.arange(K, device=dev)
    cand_mask = (ids < store.count) & ((new_idx - ids) >= config.loop_closure_min_id_gap)
    d = torch.linalg.norm(store.pose_graph.t - new_pose_graph.t[None, :], dim=-1)
    d = torch.where(cand_mask, d, float("inf"))
    k = max(1, min(config.loop_closure_candidates, K))
    vals, cands = torch.topk(d, k, largest=False, sorted=True)
    cand_ok = torch.isfinite(vals) & (vals <= config.loop_closure_radius)
    host = to_host(torch.stack([cands.to(torch.float32), cand_ok.to(torch.float32)]))
    edges, n_ok = state.edges, 0
    if not host[1].any():
        return edges, 0

    icfg = dataclasses.replace(config.icp_mapping, mode=config.loop_closure_icp_mode)
    plane = icfg.mode == "plane"
    new_cloud = pc.PointCloud(points=store.points[new_idx], mask=store.point_mask[new_idx])
    new_covs = odo.compute_covariances(new_cloud, icfg) if plane else None
    n_src = torch.clamp(new_cloud.count(), min=1).to(torch.float32)
    info = _information(config.loop_information, dev)
    for cand, in_radius in zip(host[0].astype(int), host[1] > 0):
        if not in_radius:
            continue
        cand_cloud = pc.PointCloud(points=store.points[cand], mask=store.point_mask[cand])
        cand_covs = odo.compute_covariances(cand_cloud, icfg) if plane else None
        init = se3.relative(se3.index(store.pose_graph, cand), new_pose_graph)
        res = icp_ops.icp(
            new_cloud, cand_cloud, icfg, init=init,
            source_covs=new_covs, target_covs=cand_covs,
        )
        inlier_ratio = res.num_correspondences.to(torch.float32) / n_src
        ok = (
            res.converged
            & (res.fitness < icfg.fitness_threshold)
            & (inlier_ratio >= config.loop_closure_min_inlier_ratio)
        )
        edges = pg.add_edge(edges, int(cand), new_idx, res.pose, info, enable=ok)
        n_ok += int(to_host(ok))
    return edges, n_ok


def _optimize(state: SlamState, config, counts: dict) -> Tuple[SlamState, torch.Tensor]:
    """The graph solve, then the map reset and the ``map→odom`` recompute.
    ``counts`` holds the host values of the keyframe, edge and
    loop-since-last-solve counters.

    JAX's rule (``slam.py:377-401``): with ``graph_incremental``, a full
    bucketed solve runs when a loop closure arrived since the last solve
    or the graph still fits the window; otherwise only the trailing
    ``graph_window`` nodes are solved, conditioned on the frozen prefix.
    """
    store = state.keyframes
    n_kf, n_edges, lc_since = counts["keyframes"], counts["edges"], counts["lc_since_opt"]
    kw = dict(iterations=config.graph_solver_iterations, mode=config.graph_solver)
    use_full = not config.graph_incremental or lc_since > 0 or n_kf <= config.graph_window
    if use_full:
        min_bucket = config.graph_bucket_min if config.graph_bucketing else store.capacity
        opt_nodes, stats = pg.optimize_bucketed(
            store.pose_graph, state.edges, store.valid_mask(), n_kf, n_edges,
            min_bucket=min_bucket, linear_solver=config.graph_linear_solver, **kw,
        )
    else:
        opt_nodes, stats = pg.optimize_window(
            store.pose_graph, pg.live_edges(state.edges, n_edges), store.valid_mask(),
            n_kf, config.graph_window, **kw,
        )
    new_store = kf.set_graph_poses(store, opt_nodes)
    m2o = se3.compose(kf.latest(new_store), se3.inverse(kf.latest_odom(new_store)))
    new_map = map_backend.reset(state.map) if config.reset_map_on_optimize else state.map
    zero = torch.zeros_like(state.kf_since_opt)
    return (
        state._replace(
            keyframes=new_store,
            map=new_map,
            map_to_odom=se3.normalize(m2o),
            kf_since_opt=zero,
            lc_since_opt=zero,
            num_optimizations=state.num_optimizations + 1,
        ),
        stats.final_cost,
    )


def slam_step(
    state: SlamState, raw_scan: pc.PointCloud, config, stamp: float | None = None
) -> Tuple[SlamState, SlamOutput]:
    """Process one raw sensor-frame scan through the whole pipeline.

    ``stamp`` is the scan's time in seconds (origin-relative); without it
    the state keeps a +1.0 scan counter.
    """
    check_supported(config)
    dev = raw_scan.points.device
    f32, i32 = torch.float32, torch.int32

    # the small counters every host branch below needs, in one read
    flags = to_host(torch.stack([
        state.odom.initialized.to(i32), state.odom.skip_count.to(i32),
        state.keyframes.count, state.map.size, state.kf_since_opt,
        state.lc_since_opt, state.edges.count,
    ]))
    initialized, skip_count, n_kf, map_size, kf_since, lc_since, n_edges = (
        int(v) for v in flags
    )
    skip = bool(initialized) and skip_count > 0
    do_register = bool(initialized) and not skip

    # ---- 1. front-end odometry --------------------------------------------
    odom_state, oout = odo.odometry_step(state.odom, raw_scan, config, do_register, skip)
    new_stamp = state.stamp + 1.0 if stamp is None else torch.tensor(stamp, dtype=f32, device=dev)
    state = state._replace(odom=odom_state, stamp=new_stamp)
    raw_pose = se3.normalize(se3.compose(state.slam_pose, oout.transform))
    accepted = bool(to_host(oout.accepted)) if do_register else False

    # ---- 2. scan-to-map refinement ----------------------------------------
    do_refine = do_register and accepted and n_kf > 0 and config.enable_scan_to_map
    im, io = config.icp_mapping, config.icp_odometry
    covs_reusable = (
        im.mode == "plane" and io.mode == "plane"
        and im.covariance_mode == io.covariance_mode
        and im.covariance_radius == io.covariance_radius
        and im.covariance_sigma == io.covariance_sigma
        and im.covariance_knn == io.covariance_knn
        and im.covariance_epsilon == io.covariance_epsilon
    )
    if do_refine:
        r = scan_to_map.refine_and_grow(
            state.map, oout.filtered, raw_pose, config, map_empty=map_size == 0,
            scan_covs=oout.filtered_covs if covs_reusable else None,
        )
        new_map, slam_pose, refined, refine_hess = r.map, r.refined_pose, r.success, r.hessian
    else:
        new_map, slam_pose = state.map, raw_pose
        refined = torch.tensor(False, device=dev)
        refine_hess = torch.zeros((6, 6), device=dev)
    state = state._replace(map=new_map, slam_pose=slam_pose)

    # ---- 3. keyframe gate (the first scan always makes a keyframe) ---------
    if n_kf == 0:
        want_kf = True
    elif accepted:
        moved = se3.distance_translation(slam_pose, kf.latest_odom(state.keyframes))
        want_kf = bool(to_host(moved > config.keyframe_distance))
    else:
        want_kf = False
    if config.keyframe_eviction == "none":
        want_kf = want_kf and n_kf < state.keyframes.capacity
    elif want_kf and n_kf >= state.keyframes.capacity:
        raise NotImplementedError(
            "marginalization at a full keyframe store is not ported yet — "
            "ROADMAP.md Queue 1, 'marginalisation'"
        )

    if config.adaptive_information:
        meas_hess = torch.where(refined, refine_hess, oout.hessian)
        seq_info = _adaptive_information(meas_hess, config.icp_information)
    else:
        seq_info = _information(config.icp_information, dev)
    pose_cov = torch.linalg.inv_ex(seq_info + 1e-6 * torch.eye(6, device=dev))[0]

    kf_idx, loop_added = -1, 0
    if want_kf:
        node_pose = se3.normalize(se3.compose(state.map_to_odom, slam_pose))
        prev_idx = max(n_kf - 1, 0)
        prev_odom = kf.latest_odom(state.keyframes)
        store2, _ = kf.add(
            state.keyframes, slam_pose, node_pose, oout.filtered, state.stamp, cov=pose_cov
        )
        kf_idx = n_kf
        edges2 = pg.add_edge(
            state.edges, prev_idx, kf_idx, se3.relative(prev_odom, slam_pose),
            seq_info, enable=n_kf > 0,
        )
        n_edges += int(n_kf > 0)
        n_kf += 1
        kf_since += 1
        state = state._replace(
            keyframes=store2,
            edges=edges2,
            kf_since_opt=state.kf_since_opt + 1,
            wheel_at_last_kf=state.robot_odom.pose,
            wheel_kf_valid=state.robot_odom.initialized,
        )
        if config.enable_loop_closure:
            edges3, loop_added = _try_loop_closure(state, kf_idx, node_pose, config)
            n_edges += loop_added
            lc_since += loop_added
            state = state._replace(
                edges=edges3,
                num_loop_closures=state.num_loop_closures + loop_added,
                lc_since_opt=state.lc_since_opt + loop_added,
            )

    # ---- 4. graph optimization ---------------------------------------------
    do_opt = want_kf and kf_since >= config.keyframes_window
    if do_opt:
        # the edge store drops at capacity, so the live count is capped
        counts = dict(
            keyframes=n_kf, edges=min(n_edges, state.edges.capacity), lc_since_opt=lc_since
        )
        state, opt_cost = _optimize(state, config, counts)
    else:
        opt_cost = torch.tensor(float("inf"), device=dev)

    pose_map = se3.normalize(se3.compose(state.map_to_odom, state.slam_pose))
    want_t = torch.tensor(want_kf, device=dev)
    loop_t = torch.tensor(loop_added, dtype=i32, device=dev)
    opt_t = torch.tensor(do_opt, device=dev)
    map_total = map_backend.total_size(state.map)
    packed = torch.cat([
        pose_map.t.to(f32).reshape(-1), pose_map.q.to(f32).reshape(-1),
        torch.stack([
            oout.accepted.to(f32), oout.fitness.to(f32),
            oout.num_correspondences.to(f32), oout.iterations.to(f32),
            refined.to(f32), want_t.to(f32), loop_t.to(f32), opt_t.to(f32),
            map_total.to(f32), state.keyframes.count.to(f32), opt_cost.to(f32),
        ]),
    ])
    out = SlamOutput(
        odom_out=oout,
        pose_map=pose_map,
        refined=refined,
        new_keyframe=want_t,
        keyframe_index=torch.tensor(kf_idx, dtype=i32, device=dev),
        loop_closure=loop_t,
        optimized=opt_t,
        graph_cost=opt_cost,
        map_size=map_total,
        num_keyframes=state.keyframes.count,
        pose_cov=pose_cov,
        packed=packed,
    )
    return state, out
