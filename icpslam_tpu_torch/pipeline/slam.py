"""Full SLAM step: odometry → scan-to-map → keyframes → pose graph (port of
``icpslam_tpu/pipeline/slam.py``).

``state, out = slam_step(state, scan, config)`` keeps the JAX contract:
the same ``SlamState`` / ``SlamOutput`` fields and the packed (18,) per-scan
record. The JAX ``lax.cond``s around refinement, the keyframe branch and
the optimization (``slam.py:536,657,677``) become host branches: the step
reads the state's small counters once at its start and a few flags as it
goes, each through the counted :func:`~icpslam_tpu_torch.utils.sync.to_host`.

At a full keyframe store the step marginalizes the most redundant
keyframe (``graph/marginalize.py``) before it adds the new one, and it
then reads the edge count and the victim's index (one host read, on
eviction scans only). Wheel odometry enters through
:func:`ingest_wheel_odometry` and adds a wheel edge beside each sequential
edge when ``enable_wheel_odom_edges``.

On the card the graph solve replays a CUDA graph (``graph/captured.py``);
on the CPU it runs eagerly. With ``defer_optimization`` the step leaves
the solve out, and ``pipeline/deferred.py`` runs it beside the stream.
The step makes no host-to-device copy of its own: scalars are filled on
the device, small constants copied without a stream sync.

With ``collect_debug`` the output carries the map-NN cloud and the
odometry pose before refinement (``DebugInfo``), as JAX's does.
:func:`run_scans` drives a chunk of scans, step by step, and stacks the
outputs.

``mesh`` (``parallel/mesh.py``) is the mesh of shards that
``map_backend='sharded'`` partitions the map over and that the
``dist-*`` linear solvers shard the full solve's edges over; the rest of
the step is replicated. Without one those options raise JAX's
``ValueError``s.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from icpslam_tpu_torch.cloud import pointcloud as pc
from icpslam_tpu_torch.geometry import se3
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.graph import captured as captured_mod
from icpslam_tpu_torch.graph import keyframes as kf
from icpslam_tpu_torch.graph import marginalize as marg
from icpslam_tpu_torch.graph import pose_graph as pg
from icpslam_tpu_torch.mapping import backend as map_backend
from icpslam_tpu_torch.mapping import scan_to_map
from icpslam_tpu_torch.ops import icp as icp_ops
from icpslam_tpu_torch.parallel import dist_graph
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


class HostCounts(NamedTuple):
    """The host's copy of the state's counters after a step (no extra
    read: the step keeps them as it goes), for a caller that must decide
    without a device sync, such as ``pipeline/deferred.DeferredBackend``."""
    keyframes: int
    edges: int         # live edges, capped at the store's capacity
    kf_since_opt: int
    lc_since_opt: int
    evicted: int       # the keyframe index marginalized out by this step, or -1


class DebugInfo(NamedTuple):
    """Per-scan intermediate clouds (``config.collect_debug``): the
    reference's debug topics as data."""
    nn_points: torch.Tensor  # (N, 3) robot-frame map-NN cloud
    nn_mask: torch.Tensor    # (N,)
    raw_pose: Pose           # the odometry pose before refinement (odom frame)


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
    host: Optional[HostCounts] = None
    debug: Optional[DebugInfo] = None  # only with config.collect_debug


_SOLVERS = ("auto", "direct", "pcg", "schur")


def check_supported(config) -> None:
    """Raise ``ValueError`` for invalid configurations. Unlike JAX, an unknown
    ``keyframe_eviction`` is refused instead of acting as 'marginalize',
    and an unknown ``map_backend`` or ``graph_linear_solver`` is refused
    instead of acting as 'voxel' or failing inside the first solve."""
    odo.check_supported(config)
    map_backend.check_supported(config)
    if config.keyframe_eviction not in ("none", "marginalize"):
        raise ValueError(
            f"keyframe_eviction={config.keyframe_eviction!r}: expected 'none' or 'marginalize'"
        )
    if (config.keyframe_eviction == "marginalize"
            and config.max_keyframes <= config.keyframe_protect_recent + 1):
        raise ValueError(
            "keyframe_eviction='marginalize' needs max_keyframes > keyframe_protect_recent + 1"
        )
    solver = config.graph_linear_solver
    if solver not in _SOLVERS and solver not in tuple("dist-" + s for s in _SOLVERS):
        raise ValueError(f"graph_linear_solver={solver!r}: expected one of {_SOLVERS} or "
                         "their dist-* variants")


def check_mesh(config, mesh) -> None:
    """JAX's ``ValueError``s (``slam.py:477-490``): the sharded map and the
    dist-* solvers need a mesh, and the mesh's shard count must equal
    ``config.map_shards``."""
    if config.map_backend == "sharded":
        if mesh is None:
            raise ValueError("map_backend='sharded' requires a mesh")
        if mesh.size != config.map_shards:
            raise ValueError(
                f"mesh has {mesh.size} devices but config.map_shards="
                f"{config.map_shards}; they must match (the map's leading "
                "device axis is sized by map_shards)"
            )
    if config.graph_linear_solver.startswith("dist-") and mesh is None:
        raise ValueError(
            f"graph_linear_solver='{config.graph_linear_solver}' requires a "
            "mesh (the windowed solve runs edge-sharded across it)"
        )


def init_state(config, initial_pose: Optional[Pose] = None, device=None,
               mesh=None) -> SlamState:
    """The empty SLAM state on ``device`` (default: the CUDA card, or the
    mesh's device; raises without one — pass ``device="cpu"`` for the
    CPU). No mesh is needed, as in JAX: the sharded map then has all
    ``config.map_shards`` shards; on a mesh with a process group it has
    this rank's ``mesh.local``."""
    check_supported(config)
    device = resolve_device(device if device is not None or mesh is None else mesh.device)
    i32 = torch.int32
    return SlamState(
        odom=odo.init_state(config, initial_pose, device=device),
        robot_odom=robot_odo.init_state(device=device),
        wheel_at_last_kf=se3.identity(device=device),
        wheel_kf_valid=torch.tensor(False, device=device),
        map=map_backend.empty(config, device=device, mesh=mesh),
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


def bootstrap_pose(state: SlamState, pose: Pose) -> SlamState:
    """Seed the odometer from external (wheel) odometry."""
    return state._replace(odom=odo.set_initial_pose(state.odom, pose), slam_pose=pose)


def ingest_wheel_odometry(
    state: SlamState, raw_pose: Pose, config, covariance: torch.Tensor | None = None
) -> SlamState:
    """Feed one external odometry message: its offset-removed pose seeds
    the scan odometer until the first scan arrives, and the stream is kept
    for the wheel-odometry edges. No host read."""
    ro_state, out = robot_odo.robot_odometry_step(state.robot_odom, raw_pose, config, covariance)
    need_bootstrap = ~state.odom.initialized
    return state._replace(
        robot_odom=ro_state,
        odom=state.odom._replace(pose=se3.where(need_bootstrap, out.pose, state.odom.pose)),
        slam_pose=se3.where(need_bootstrap, out.pose, state.slam_pose),
    )


def _vector(values, device) -> torch.Tensor:
    """A float32 constant on ``device``, copied without a stream sync."""
    return torch.tensor(values, dtype=torch.float32).to(device, non_blocking=True)


def _information(diag, device) -> torch.Tensor:
    return torch.diag(_vector(diag, device))


def _adaptive_information(H: torch.Tensor, diag) -> torch.Tensor:
    """Edge information from the registration's GN Hessian, rescaled block
    by block to the configured diagonals (see the JAX docstring)."""
    fixed = _information(diag, H.device)
    d = _vector(diag, H.device)
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


def graph_solve(state: SlamState, config, counts: dict, full: bool, captured=None,
                copied=None, mesh=None) -> Tuple[Pose, pg.SolveStats]:
    """The full (bucketed) or the window solve of the state's graph.
    ``counts`` holds the host values of the keyframe and edge counts.

    With ``captured`` (a ``graph/captured.CapturedSolves``) the solve is a
    graph replay, Schur excepted; without it, it runs eagerly. ``copied``,
    a CUDA event, is recorded once every read of ``state`` is enqueued:
    after the copy into the graph's inputs, or after an eager solve.

    A ``dist-*`` solver runs the full solve edge-sharded over ``mesh``
    (``parallel/dist_graph.optimize`` per bucket, JAX's ``optimize_fn``);
    it is captured only on a mesh without a process group. The window
    solve stays replicated, as in JAX.
    """
    store, edges = state.keyframes, state.edges
    mask = store.valid_mask()
    kw = dict(iterations=config.graph_solver_iterations, mode=config.graph_solver)
    if full:
        min_bucket = config.graph_bucket_min if config.graph_bucketing else store.capacity
        bucket = pg.bucket_size(counts["keyframes"], counts["edges"], store.capacity,
                                edges.capacity, min_bucket)
        name = config.graph_linear_solver
        dist_mesh = mesh if name.startswith("dist-") else None
        if name.startswith("dist-") and mesh is None:
            raise ValueError(f"graph_linear_solver='{name}' requires a mesh")
        solver = pg.resolve_linear_solver(name.removeprefix("dist-"), bucket)
        eager_only = solver == "schur" or (dist_mesh is not None and dist_mesh.group is not None)
        if captured is not None and not eager_only:
            g = captured.prepare_full(store.pose_graph, edges, mask, bucket, solver,
                                      mesh=dist_mesh, **kw)
        else:
            g = None
            optimize_fn = (None if dist_mesh is None
                           else functools.partial(dist_graph.optimize, mesh=dist_mesh))
            out = pg.solve_bucket(store.pose_graph, edges, mask, bucket, solver,
                                  optimize_fn=optimize_fn, **kw)
    elif captured is not None:
        g = captured.prepare_window(store.pose_graph, edges, mask, store.count,
                                    config.graph_window, **kw)
    else:
        g = None
        out = pg.optimize_window(store.pose_graph, edges, mask, store.count,
                                 config.graph_window, **kw)
    if copied is not None:
        copied.record()
    return g.run() if g is not None else out


def _optimize(state: SlamState, config, counts: dict, mesh=None
              ) -> Tuple[SlamState, torch.Tensor]:
    """The graph solve, then the map reset and the ``map→odom`` recompute.
    ``counts`` holds the host values of the keyframe, edge and
    loop-since-last-solve counters.

    JAX's rule (``slam.py:377-401``): with ``graph_incremental``, a full
    bucketed solve runs when a loop closure arrived since the last solve
    or the graph still fits the window; otherwise only the trailing
    ``graph_window`` nodes are solved, conditioned on the frozen prefix.
    """
    store = state.keyframes
    full = (not config.graph_incremental or counts["lc_since_opt"] > 0
            or counts["keyframes"] <= config.graph_window)
    captured = captured_mod.for_device(store.count.device)
    opt_nodes, stats = graph_solve(state, config, counts, full, captured, mesh=mesh)
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
    state: SlamState, raw_scan: pc.PointCloud, config, stamp: float | None = None, mesh=None
) -> Tuple[SlamState, SlamOutput]:
    """Process one raw sensor-frame scan through the whole pipeline.

    ``stamp`` is the scan's time in seconds (origin-relative); without it
    the state keeps a +1.0 scan counter. ``mesh``: the mesh of the sharded
    map and the dist-* solvers (JAX's ``mesh``); every rank of a mesh with
    a process group steps the same scan.
    """
    check_supported(config)
    check_mesh(config, mesh)
    dev = raw_scan.points.device
    f32, i32 = torch.float32, torch.int32

    # the small counters every host branch below needs, in one read
    flags = to_host(torch.stack([
        state.odom.initialized.to(i32), state.odom.skip_count.to(i32),
        state.keyframes.count, map_backend.total_size(state.map, mesh), state.kf_since_opt,
        state.lc_since_opt, state.edges.count, state.robot_odom.initialized.to(i32),
        state.wheel_kf_valid.to(i32),
    ]))
    (initialized, skip_count, n_kf, map_size, kf_since, lc_since, n_edges, wheel_init,
     wheel_kf_valid) = (int(v) for v in flags)
    skip = bool(initialized) and skip_count > 0
    do_register = bool(initialized) and not skip

    # ---- 1. front-end odometry --------------------------------------------
    odom_state, oout = odo.odometry_step(state.odom, raw_scan, config, do_register, skip)
    new_stamp = state.stamp + 1.0 if stamp is None else torch.full((), stamp, dtype=f32, device=dev)
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
            scan_covs=oout.filtered_covs if covs_reusable else None, mesh=mesh,
        )
        new_map, slam_pose, refined, refine_hess = r.map, r.refined_pose, r.success, r.hessian
        nn_points, nn_mask = r.nn_points, r.nn_mask
    else:
        new_map, slam_pose = state.map, raw_pose
        refined = torch.zeros((), dtype=torch.bool, device=dev)
        refine_hess = torch.zeros((6, 6), device=dev)
        nn_points = torch.zeros((oout.filtered.capacity, 3), device=dev)
        nn_mask = torch.zeros((oout.filtered.capacity,), dtype=torch.bool, device=dev)
    state = state._replace(map=new_map, slam_pose=slam_pose)
    debug = (DebugInfo(nn_points=nn_points, nn_mask=nn_mask, raw_pose=raw_pose)
             if config.collect_debug else None)

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

    if config.adaptive_information:
        meas_hess = torch.where(refined, refine_hess, oout.hessian)
        seq_info = _adaptive_information(meas_hess, config.icp_information)
    else:
        seq_info = _information(config.icp_information, dev)
    pose_cov = torch.linalg.inv_ex(seq_info + 1e-6 * torch.eye(6, device=dev))[0]

    kf_idx, loop_added, evicted = -1, 0, -1
    if want_kf:
        if n_kf >= state.keyframes.capacity:
            # a full store: marginalize the most redundant keyframe first
            victim = marg.select_victim(
                state.keyframes, state.edges,
                protect_recent=config.keyframe_protect_recent,
                loop_edge_penalty=config.keyframe_loop_edge_penalty,
            )
            store, edges = marg.marginalize_keyframe(state.keyframes, state.edges, victim)
            state = state._replace(keyframes=store, edges=edges)
            n_kf -= 1
            # fusion and compaction changed the edge count; the victim's
            # index joins the read for a deferred solve in flight
            n_edges, evicted = (int(v) for v in to_host(torch.stack([edges.count, victim])))
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
        if config.enable_wheel_odom_edges:
            # the wheel-odometry edge between the same keyframe pair
            wheel_ok = n_kf > 0 and bool(wheel_init) and bool(wheel_kf_valid)
            wheel_rel = se3.relative(state.wheel_at_last_kf, state.robot_odom.pose)
            edges2 = pg.add_edge(
                edges2, prev_idx, kf_idx, wheel_rel,
                _information(config.odometry_information, dev), enable=wheel_ok,
            )
            n_edges += int(wheel_ok)
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
    # with defer_optimization the solve leaves the step (JAX slam.py:662-668)
    do_opt = want_kf and kf_since >= config.keyframes_window and not config.defer_optimization
    # the edge store drops at capacity, so the live count is capped
    n_edges = min(n_edges, state.edges.capacity)
    if do_opt:
        counts = dict(keyframes=n_kf, edges=n_edges, lc_since_opt=lc_since)
        state, opt_cost = _optimize(state, config, counts, mesh)
        kf_since = lc_since = 0
    else:
        opt_cost = torch.full((), float("inf"), device=dev)

    pose_map = se3.normalize(se3.compose(state.map_to_odom, state.slam_pose))
    want_t = torch.full((), want_kf, dtype=torch.bool, device=dev)
    loop_t = torch.full((), loop_added, dtype=i32, device=dev)
    opt_t = torch.full((), do_opt, dtype=torch.bool, device=dev)
    map_total = map_backend.total_size(state.map, mesh)
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
        keyframe_index=torch.full((), kf_idx, dtype=i32, device=dev),
        loop_closure=loop_t,
        optimized=opt_t,
        graph_cost=opt_cost,
        map_size=map_total,
        num_keyframes=state.keyframes.count,
        pose_cov=pose_cov,
        packed=packed,
        host=HostCounts(keyframes=n_kf, edges=n_edges, kf_since_opt=kf_since,
                        lc_since_opt=lc_since, evicted=evicted),
        debug=debug,
    )
    return state, out


def _stack(outs):
    """Stack a list of like NamedTuples of tensors along a new leading axis;
    None fields stay None."""
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    return type(first)(*(_stack([getattr(o, f) for o in outs]) for f in first._fields))


def run_scans(
    state: SlamState, scans: pc.PointCloud, config, stamps=None, mesh=None
) -> Tuple[SlamState, SlamOutput]:
    """A chunk of scans through :func:`slam_step`: ``scans`` is a stacked
    cloud ``(T, N, 3)`` / ``(T, N)``, ``stamps`` T stamps or None. The
    outputs gain the leading axis (JAX's ``lax.scan`` contract,
    ``pipeline/slam.py::run_scans``); ``host`` is the last step's, which
    holds the state's counters after the chunk. A host loop: the steps
    launch exactly the kernels of one-by-one driving, in the same order.
    """
    outs, hosts = [], []
    for i in range(scans.points.shape[0]):
        stamp = None if stamps is None else float(stamps[i])
        state, out = slam_step(state, pc.PointCloud(scans.points[i], scans.mask[i]), config,
                               stamp=stamp, mesh=mesh)
        hosts.append(out.host)
        outs.append(out._replace(host=None))
    return state, _stack(outs)._replace(host=hosts[-1])
