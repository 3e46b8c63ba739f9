"""Runner + CLI: stream scans through the port's ``slam_step`` (port of
``icpslam_tpu/io/runner.py``).

    python -m icpslam_tpu_torch.io.runner --synthetic --poses 20
    python -m icpslam_tpu_torch.io.runner --kitti-proxy --poses 500
    python -m icpslam_tpu_torch.io.runner --kitti /data/kitti --seq 04 --out traj.npz
    python -m icpslam_tpu_torch.io.runner --kitti ROOT --seq 99 --end 250 --save-state ck.npz
    python -m icpslam_tpu_torch.io.runner --kitti ROOT --seq 99 --start 250 --resume ck.npz
    python -m icpslam_tpu_torch.io.runner --watch /var/spool/scans --html view.html
    python -m icpslam_tpu_torch.io.runner --synthetic --poses 20 --deferred-optimize --trace DIR

Sources, one of: ``--synthetic``, the JAX runner's room loop; ``--kitti-proxy``,
the urban proxy rendered with the sensor physics (motion distortion across
the sweep, range-dependent noise, 8% dropout, moving traffic) and
registered with the in-loop coupled de-skew with the freed source twist,
which the run turns on when no de-skew flag is given (``--deskew``
de-skews at ingest with a noisy INS instead, ``--no-proxy-physics`` gives
the idealized render, ``--scan-cache FILE`` keeps the render in the JAX
runner's ``.npz`` format); ``--kitti ROOT`` with ``--seq``, ``--start`` and
``--end``, a KITTI odometry tree read by the native prefetching loader
(``io/native_loader.py``; the Python reader when the library cannot be
built, and the summary's ``"loader"`` says which ran), with the ground
truth converted to the velodyne frame (no de-skew default: real odometry
clouds arrive motion-compensated); ``--watch DIR``, live ``.bin`` files as
they arrive (``io/live.py``).

The config follows the JAX runner: ``--config`` YAML, else
``kitti_config()`` for the KITTI sources and the room config for
``--synthetic``; flags given explicitly override it (``--voxel``,
``--map-resolution``, ``--skip``, ``--keyframe-distance``, ``--window``,
``--max-points``, ``--max-raw-points``, ``--max-map-points``,
``--max-keyframes`` with ``max_edges`` = 4×, ``--verbosity``,
``--extrinsic``), then ``--icp-mode``, ``--adaptive-information``,
``--keyframe-eviction`` and the ``--deskew-*`` flags.

Run flags: ``--chunk N`` drives N scans per ``slam.run_scans`` call (a
trailing partial chunk is padded with empty scans whose outputs are
dropped; ``post_step`` runs once per chunk); ``--out`` writes the
trajectory (``t``, ``q``, ``gt_t``, ``gt_q``) as ``.npz``; ``--save-state``
checkpoints the final state and ``--resume`` starts from one, with the map
re-rendered from the keyframes; ``--debug-dump DIR`` writes the products of
rejected and unrefined scans (``scan_%06d_<reason>.npz``); ``--html`` writes
the viewer, refreshed every ``--html-every`` scans during the run
(``--debug-dump`` and ``--html-every`` need ``--chunk 1``);
``--deferred-optimize`` runs the graph solve beside the stream
(``pipeline/deferred.py``); ``--trace DIR`` writes a ``torch.profiler``
trace. Scans are prepared and uploaded three ahead of the step on a
thread (``io/prefetch.py``; on the card into pinned memory and on a side
stream), so the step time excludes the upload.

The run prints ATE/RPE against the ground truth and a one-line JSON
summary: JAX's keys, and the port's host syncs, kernel launches, solves
and the loader. ``--device`` defaults to ``cuda`` and fails without a
card; the CPU runs only with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from icpslam_tpu_torch.cloud import pointcloud as pc
from icpslam_tpu_torch.config import IcpConfig, SlamConfig, from_yaml, kitti_config
from icpslam_tpu_torch.eval import metrics
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.graph import pose_graph
from icpslam_tpu_torch.io import prefetch as prefetch_mod
from icpslam_tpu_torch.io import synthetic
from icpslam_tpu_torch.mapping import backend as map_backend
from icpslam_tpu_torch.ops import nn as nn_ops
from icpslam_tpu_torch.ops import radius_stats
from icpslam_tpu_torch.pipeline import deferred, slam
from icpslam_tpu_torch.utils import profiling
from icpslam_tpu_torch.utils.logging import Logger
from icpslam_tpu_torch.utils.sync import to_host

# the kernel wrappers, by the name the summary reports their launches under
KERNELS = {
    "nn1": nn_ops.nn1_cuda,                          # K1
    "knn": nn_ops.knn_cuda,                          # K2
    "radius": radius_stats.radius_moments_cuda,      # K3
    "nn1_matmul": nn_ops.nn1_matmul_cuda,            # K4
}


@dataclasses.dataclass
class RunResult:
    trajectory: Pose          # (T,) map-frame pose per scan, on the host
    records: np.ndarray       # (T, 18) packed per-scan records
    processed: np.ndarray     # (T,) bool: the scan was registered
    state: slam.SlamState
    wall_time: float
    step_ms: List[float]      # per-scan step time, device work included, upload excluded
    host_syncs: List[float]   # counted host reads per scan
    launches: Dict[str, List[float]]  # per kernel of KERNELS, launches per scan (CUDA only)
    window_solves: List[float]  # incremental window solves per scan
    pcg_solves: List[float]   # graph solves by PCG per scan
    stamp_origin: Optional[float] = None  # the stream's first stamp; device stamps are relative
    setup_ms: float = 0.0     # entry to the first scan: state set-up, stream start
    trailing_ms: float = 0.0  # loop exit to return: the records' read

    def timing_summary(self) -> dict:
        """JAX's timing keys: the first scan's time (the kernels' build
        and load, CUDA set-up) as ``compile_ms``, the rest's mean, median,
        p95 (and p99) and max, and every second of the wall time attributed."""
        out = {}
        if not self.step_ms:
            return out
        out["compile_ms"] = float(self.step_ms[0])
        a = np.asarray(self.step_ms[1:] or self.step_ms, np.float64)
        out.update(step_ms_mean=float(a.mean()), step_ms_p50=float(np.median(a)),
                   step_ms_p95=float(np.percentile(a, 95)), step_ms_p99=float(np.percentile(a, 99)),
                   step_ms_max=float(a.max()))
        timed_s = float(np.sum(self.step_ms)) / 1000.0
        setup_s, trail_s = self.setup_ms / 1000.0, self.trailing_ms / 1000.0
        host_s = max(self.wall_time - timed_s - setup_s - trail_s, 0.0)
        out["wall_vs_step"] = {
            "wall_s": self.wall_time, "timed_step_loop_s": timed_s, "setup_s": setup_s,
            "trailing_s": trail_s, "host_unoverlapped_s": host_s,
            "host_ms_per_scan": host_s * 1000.0 / len(self.step_ms),
        }
        return out

    def summary(self) -> dict:
        r = self.records
        n = int(r.shape[0])
        reg = np.asarray(self.processed, bool)
        out = {
            "scans": n,
            "wall_time_s": self.wall_time,
            "wall_scans_per_sec": n / self.wall_time if n and self.wall_time else 0.0,
            "accepted": int(r[:, 7].sum()),
            "processed": int(reg.sum()),
            "keyframes": int(self.state.keyframes.count),
            "keyframe_evictions": int(self.state.keyframes.evictions),
            "edges": int(self.state.edges.count),
            "edge_overflow": int(self.state.edges.overflow),
            "loop_closures": int(self.state.num_loop_closures),
            "optimizations": int(self.state.num_optimizations),
            "window_solves": int(sum(self.window_solves)),
            "full_solves": int(self.state.num_optimizations) - int(sum(self.window_solves)),
            "pcg_solves": int(sum(self.pcg_solves)),
            "map_size": int(map_backend.total_size(self.state.map)),
            "map_overflow": int(map_backend.total_overflow(self.state.map)),
            "host_syncs_per_scan": float(np.mean(self.host_syncs)) if self.host_syncs else 0.0,
        }
        if self.stamp_origin is not None:
            out["stamp_origin"] = self.stamp_origin
        without = {}
        for name, per_scan in self.launches.items():
            out[f"{name}_launches_per_scan"] = float(np.mean(per_scan)) if per_scan else 0.0
            without[name] = int((np.asarray(per_scan)[reg] == 0).sum()) if per_scan else 0
        # registered scans in which a kernel was not launched (on the CPU
        # no wrapper launches, so there it counts every registered scan)
        out["registered_scans_without_launch"] = without
        out.update(self.timing_summary())
        if self.step_ms:
            a = np.asarray(self.step_ms[1:] or self.step_ms)
            out["step_ms_p90"] = float(np.percentile(a, 90))
        return out


def _dump_debug_scan(debug_dir: str, i: int, out: slam.SlamOutput, reason: str) -> None:
    """Write one failing scan's products (the filtered cloud, the map-NN
    cloud, the poses, the gates) as JAX's runner does: file
    ``scan_%06d_<reason>.npz``, JAX's keys."""
    os.makedirs(debug_dir, exist_ok=True)
    o = out.odom_out
    fm = to_host(o.filtered.mask)
    payload = dict(
        scan=i,
        reason=reason,
        fitness=float(to_host(o.fitness)),
        correspondences=int(to_host(o.num_correspondences)),
        iterations=int(to_host(o.iterations)),
        filtered_points=to_host(o.filtered.points)[fm],
        pose_map_t=to_host(out.pose_map.t),
        pose_map_q=to_host(out.pose_map.q),
    )
    if out.debug is not None:
        nm = to_host(out.debug.nn_mask)
        payload.update(
            nn_points=to_host(out.debug.nn_points)[nm],
            raw_pose_t=to_host(out.debug.raw_pose.t),
            raw_pose_q=to_host(out.debug.raw_pose.q),
        )
    np.savez_compressed(os.path.join(debug_dir, f"scan_{i:06d}_{reason}.npz"), **payload)


def run_slam(
    scans: Iterable, config: SlamConfig, initial_pose: Optional[Pose] = None, device=None,
    post_step: Optional[Callable[[slam.SlamState, slam.SlamOutput], slam.SlamState]] = None,
    chunk: int = 1,
    state: Optional[slam.SlamState] = None,
    logger: Optional[Logger] = None,
    debug_dir: Optional[str] = None,
    debug_max_dumps: int = 200,
    snapshot_every: int = 0,
    snapshot_fn=None,
    prefetch_depth: int = 3,
    mesh=None,
) -> RunResult:
    """Host loop over ``slam_step``. ``scans`` yields ``((points, mask),
    stamp)`` numpy pairs; device stamps are relative to the first one
    (``stamp_origin``). ``state`` resumes from a given state (its device
    wins over ``device``). ``post_step(state, out) -> state`` runs after
    every step, or every chunk (the deferred back end). With ``chunk > 1``
    the scans go ``chunk`` at a time through ``slam.run_scans``, a trailing
    partial chunk padded with empty scans stamped as the last live one,
    whose outputs are dropped; the chunk's time, syncs and launches are
    spread evenly over its live scans. ``debug_dir`` dumps the products of
    rejected and unrefined scans (``chunk`` 1 only; one host read per
    scan), ``snapshot_fn(i, state, trajectory)`` runs every
    ``snapshot_every`` scans. Scans are prepared and uploaded
    ``prefetch_depth`` ahead on a thread. Each step (or chunk) ends by
    synchronizing the current stream, so ``step_ms`` holds its device work
    but not the upload, nor a solve running on another stream. ``mesh``
    goes to every step (the sharded map and the dist-* solvers)."""
    t0 = time.perf_counter()
    if debug_dir is not None and chunk > 1:
        raise ValueError("--debug-dump requires chunk=1 (per-scan products)")
    log = logger or Logger(level=config.verbosity)
    if state is None:
        state = slam.init_state(config, initial_pose, device=device, mesh=mesh)
    device = state.slam_pose.t.device
    cuda = device.type == "cuda"
    uploader = prefetch_mod.Uploader(device, slots=max(prefetch_depth, 0) + 2)
    origin: List[float] = []

    def prep(item):
        arrays, stamp = item
        if not origin:
            origin.append(float(stamp))
        return uploader.upload(arrays), float(stamp) - origin[0]

    packed, processed, step_ms, syncs, windows, pcgs = [], [], [], [], [], []
    launches = {name: [] for name in KERNELS}
    n_dumps, prev_map_size = 0, None
    buf: List[pc.PointCloud] = []
    stamp_buf: List[float] = []
    counters = {}

    def start_counts():
        counters.update(s=to_host.count, w=pose_graph.optimize_window.calls,
                        p=pose_graph.optimize.pcg_solves,
                        k={name: fn.launches for name, fn in KERNELS.items()},
                        t=time.perf_counter())

    def end_counts(live: int):
        if cuda:
            torch.cuda.current_stream(device).synchronize()
        dt = (time.perf_counter() - counters["t"]) * 1000.0
        share = lambda total: [total / live] * live  # noqa: E731
        step_ms.extend(share(dt))
        syncs.extend(share(to_host.count - counters["s"]))
        windows.extend(share(pose_graph.optimize_window.calls - counters["w"]))
        pcgs.extend(share(pose_graph.optimize.pcg_solves - counters["p"]))
        for name, fn in KERNELS.items():
            launches[name].extend(share(fn.launches - counters["k"][name]))

    def flush(state):
        live = len(buf)
        while len(buf) < chunk:
            buf.append(pc.empty(config.max_raw_points, device=device))
            stamp_buf.append(stamp_buf[-1])
        start_counts()
        stacked = pc.PointCloud(torch.stack([c.points for c in buf]),
                                torch.stack([c.mask for c in buf]))
        state, outs = slam.run_scans(state, stacked, config, stamps=stamp_buf, mesh=mesh)
        if post_step is not None:
            state = post_step(state, outs)
        end_counts(live)
        packed.append(outs.packed[:live])
        processed.append(outs.odom_out.processed[:live])
        buf.clear()
        stamp_buf.clear()
        return state

    def records() -> np.ndarray:
        """The (T, 18) records so far, in one read."""
        if not packed:
            return np.zeros((0, 18), np.float32)
        return to_host(torch.cat([p.reshape(-1, 18) for p in packed]))

    def traj(rec: np.ndarray) -> Pose:
        return Pose(t=torch.from_numpy(rec[:, :3]), q=torch.from_numpy(rec[:, 3:7]))

    setup_ms = (time.perf_counter() - t0) * 1000.0
    stream = prefetch_mod.prefetch(scans, prep, depth=prefetch_depth)
    for i, ((tensors, event), stamp) in enumerate(stream):
        if chunk > 1:
            buf.append(pc.PointCloud(*uploader.ready(tensors, event)))
            stamp_buf.append(stamp)
            if len(buf) == chunk:
                state = flush(state)
            continue
        start_counts()
        cloud = pc.PointCloud(*uploader.ready(tensors, event))
        state, out = slam.slam_step(state, cloud, config, stamp=stamp, mesh=mesh)
        if post_step is not None:
            state = post_step(state, out)
        if debug_dir is not None and n_dumps < debug_max_dumps:
            # the gates are read to decide: one host read per scan
            g = to_host(torch.stack([out.odom_out.processed.float(), out.odom_out.accepted.float(),
                                     out.refined.float(), out.num_keyframes.float(),
                                     out.map_size.float()]))
            reg, acc, refined, n_kf, map_size = bool(g[0]), bool(g[1]), bool(g[2]), int(g[3]), int(g[4])
            reason = None
            if reg and not acc:
                reason = "odometry_reject"
            elif (acc and config.enable_scan_to_map and not refined and n_kf > 1
                  # an empty map before this scan is the reseed after an
                  # optimize-reset (refined=False by design), not a failure
                  and (prev_map_size is None or prev_map_size > 0)):
                reason = "refine_fail"
            prev_map_size = map_size
            if reason is not None:
                _dump_debug_scan(debug_dir, i, out, reason)
                n_dumps += 1
                log.warn(f"scan {i}: {reason} — dumped debug products")
        if log.level >= 2:
            log.debug(f"scan {i}: record {to_host(out.packed).tolist()}")
        end_counts(1)
        packed.append(out.packed)
        processed.append(out.odom_out.processed)
        if snapshot_every and snapshot_fn is not None and (i + 1) % snapshot_every == 0:
            snapshot_fn(i, state, traj(records()))
    if buf:
        state = flush(state)
    t_trail = time.perf_counter()
    rec = records()
    registered = (to_host(torch.cat([p.reshape(-1) for p in processed])) if processed
                  else np.zeros((0,), bool))
    t_end = time.perf_counter()
    return RunResult(
        trajectory=traj(rec), records=rec, processed=registered, state=state,
        wall_time=t_end - t0, step_ms=step_ms, host_syncs=syncs,
        launches=launches, window_solves=windows, pcg_solves=pcgs,
        stamp_origin=origin[0] if origin else None, setup_ms=setup_ms,
        trailing_ms=(t_end - t_trail) * 1000.0,
    )


def synthetic_config() -> SlamConfig:
    """The JAX runner's default (``--synthetic``) config."""
    return SlamConfig(
        voxel_leaf_size=0.2,
        map_resolution=0.2,
        icp_odometry=IcpConfig(mode="plane", max_iterations=10),
        icp_mapping=IcpConfig(mode="point", max_iterations=30),
        num_clouds_skip=0,
        max_points=8192,
        max_raw_points=131072,
        max_map_points=262144,
        max_keyframes=512,
        max_edges=512 * 4,
        keyframe_distance=0.3,
        keyframes_window=4,
    )


def synthetic_source(config: SlamConfig, poses: int, rate: float):
    """The room loop: (scan stream, ground truth)."""
    world = synthetic.make_room_world(seed=0, n_points=40000)
    gt = synthetic.make_loop_trajectory(n_poses=poses, radius=5.0, laps=1.25)
    stream = synthetic.scan_stream(
        world, gt, capacity=config.max_raw_points, max_range=12.0,
        n_points=4000, noise=0.01, rate_hz=rate,
    )
    return stream, gt


def proxy_physics() -> dict:
    """The sensor-physics render options of the JAX runner's
    ``--kitti-proxy`` (``velodyne_stream`` keywords)."""
    return dict(distortion=True, dynamic=synthetic.make_moving_objects(seed=0),
                noise_range_coeff=3e-4, dropout=0.08)


def kitti_proxy_source(config: SlamConfig, poses: int, rate: float,
                       physics: bool = False, deskew: bool = False):
    """The urban proxy: (scan stream, ground truth). With no option the
    idealized render; ``physics`` renders with ``proxy_physics()``, and
    ``deskew`` then de-skews each scan at ingest with the noisy INS."""
    if deskew and not physics:
        raise ValueError("deskew undoes the physics render's motion distortion")
    world = synthetic.make_urban_world(seed=0)
    gt = synthetic.make_urban_drive(n_poses=poses, rate_hz=rate)
    kw = dict(proxy_physics(), deskew=deskew) if physics else {}
    return synthetic.velodyne_stream(
        world, gt, capacity=config.max_raw_points, rate_hz=rate, **kw), gt


def cached_proxy_source(path: str, config: SlamConfig, poses: int, rate: float,
                        physics: bool, deskew: bool, start: int = 0, log: Optional[Logger] = None):
    """``kitti_proxy_source`` through the scan cache at ``path``: its scans
    ``[start, poses)`` when its ``tag`` matches the physics flags (1 for
    physics, +2 for the INS de-skew), else a fresh render written there.
    ``start`` needs a matching cache (a resumed run replays the rendered
    stream from there)."""
    log = log or Logger()
    tag = int(physics) + 2 * int(deskew and physics)
    if os.path.exists(path):
        data = np.load(path)
        if "tag" in data and int(data["tag"]) == tag:
            n = min(poses, int(data["gt_t"].shape[0]))
            if n < poses:
                log.warn(f"scan cache {path} holds only {n} scans; running {n}")
            lo = min(start, n)
            gt = (data["gt_t"][lo:n], data["gt_q"][lo:n])
            scans = [(synthetic.pad(data[f"s{i}"], config.max_raw_points), i / rate)
                     for i in range(lo, n)]
            return scans, gt
        log.warn(f"scan cache {path} was rendered with other physics flags; re-rendering")
    if start:
        raise SystemExit("--start with --kitti-proxy requires a matching --scan-cache (a "
                         "resumed run replays the rendered stream from there)")
    stream, gt = kitti_proxy_source(config, poses, rate, physics, deskew)
    scans = list(stream)
    np.savez_compressed(path, gt_t=gt[0], gt_q=gt[1], tag=tag,
                        **{f"s{i}": p[m] for i, ((p, m), _) in enumerate(scans)})
    return scans, gt


def evaluate(res: RunResult, gt) -> dict:
    gt_pose = Pose(t=torch.from_numpy(gt[0]), q=torch.from_numpy(gt[1]))
    ate_m, _ = metrics.ate(res.trajectory, gt_pose, align=True)
    rpe_t, rpe_r = metrics.rpe(res.trajectory, gt_pose)
    return {"ate_m": ate_m, "rpe_t": rpe_t, "rpe_r": rpe_r}


def _parse_extrinsic(spec: Optional[str]):
    """'x,y,z[,qw,qx,qy,qz]' → (t tuple, q tuple); identity when None."""
    if not spec:
        return (0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0)
    vals = [float(v) for v in spec.replace(",", " ").split()]
    if len(vals) == 3:
        return tuple(vals), (1.0, 0.0, 0.0, 0.0)
    if len(vals) == 7:
        q = np.asarray(vals[3:], np.float64)
        q = q / np.linalg.norm(q)
        return tuple(vals[:3]), tuple(float(x) for x in q)
    raise ValueError("--extrinsic expects 'x,y,z' or 'x,y,z,qw,qx,qy,qz'")


# CLI dest → SlamConfig field; the flags parse with default=None, so an
# explicitly given flag, whatever its value, overrides any config source
# (the reference's launch arguments over its YAML)
_CLI_CONFIG_FIELDS = {
    "voxel": "voxel_leaf_size",
    "map_resolution": "map_resolution",
    "skip": "num_clouds_skip",
    "keyframe_distance": "keyframe_distance",
    "window": "keyframes_window",
    "max_points": "max_points",
    "max_raw_points": "max_raw_points",
    "max_map_points": "max_map_points",
    "max_keyframes": "max_keyframes",
    "verbosity": "verbosity",
}

def _explicit_overrides(args) -> dict:
    """Config overrides for the flags given explicitly."""
    overrides = {f: getattr(args, d) for d, f in _CLI_CONFIG_FIELDS.items()
                 if getattr(args, d) is not None}
    if args.extrinsic:
        ext_t, ext_q = _parse_extrinsic(args.extrinsic)
        overrides.update(laser_extrinsic_t=ext_t, laser_extrinsic_q=ext_q)
    return overrides


def _apply_icp_mode(cfg: SlamConfig, args) -> SlamConfig:
    """``--icp-mode``, when given, sets the odometry ICP mode."""
    if args.icp_mode is not None:
        cfg = cfg.replace(icp_odometry=dataclasses.replace(cfg.icp_odometry, mode=args.icp_mode))
    return cfg


def build_config(args) -> SlamConfig:
    """JAX runner.py:787-801: ``--config`` with the explicit flags over it;
    else ``kitti_config()`` for the KITTI sources and ``synthetic_config()``
    (JAX's flag defaults) for ``--synthetic``, with them over it and
    ``max_edges`` 4× an explicit ``--max-keyframes``."""
    kw = _explicit_overrides(args)
    if args.config:
        return _apply_icp_mode(from_yaml(args.config, **kw), args)
    if "max_keyframes" in kw:
        kw.setdefault("max_edges", kw["max_keyframes"] * 4)
    base = kitti_config() if args.kitti_proxy or args.kitti or args.watch else synthetic_config()
    return _apply_icp_mode(base.replace(**kw), args)


def _apply_run_flags(cfg: SlamConfig, args, log: Logger) -> SlamConfig:
    """JAX runner.py:923-956: the physics proxy turns on the coupled
    free-twist de-skew unless a de-skew flag is given; then the
    information, eviction and de-skew flags."""
    physics = args.kitti_proxy and not args.no_proxy_physics
    if physics and not args.deskew and args.deskew_rounds is None:
        cfg = cfg.replace(deskew_rounds=1, deskew_free_twist=True)
        log.info("physics proxy: no-INS de-skew on by default (coupled free-twist; "
                 "--deskew-rounds 0 to disable)")
    kw = {}
    if args.adaptive_information:
        kw["adaptive_information"] = True
    if args.keyframe_eviction is not None:
        kw["keyframe_eviction"] = args.keyframe_eviction
    if args.deskew_rounds is not None:
        kw["deskew_rounds"] = args.deskew_rounds
    if args.deskew_mode is not None:
        kw["deskew_mode"] = args.deskew_mode
    if args.deskew_free_twist:
        kw["deskew_free_twist"] = True
    if args.deskew_prior_weight is not None:
        kw["deskew_prior_weight"] = args.deskew_prior_weight
    if args.deskew_prior_huber is not None:
        kw["deskew_prior_huber"] = args.deskew_prior_huber
    if args.deskew_auto_prior is not None:
        kw["deskew_auto_prior"] = args.deskew_auto_prior == "on"
    return cfg.replace(**kw) if kw else cfg


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--synthetic", action="store_true", help="room loop")
    src.add_argument("--kitti-proxy", action="store_true", help="urban proxy (kitti_config)")
    src.add_argument("--kitti", type=str, help="KITTI odometry root")
    src.add_argument("--watch", type=str,
                     help="live ingest: velodyne .bin files as they appear in this directory "
                     "(renamed into place by the producer; a STOP file or the idle timeout ends it)")
    ap.add_argument("--seq", type=str, default="04", help="(--kitti) sequence")
    ap.add_argument("--poses", type=int, default=40, help="synthetic trajectory length")
    ap.add_argument("--start", type=int, default=0, help="first scan of the sequence")
    ap.add_argument("--end", type=int, default=None, help="end of the sequence (exclusive)")
    # size and config flags: defaults are synthetic_config()'s (kitti_config()
    # for the KITTI sources)
    ap.add_argument("--voxel", type=float, default=None, help="voxel leaf size (m), default 0.2")
    ap.add_argument("--map-resolution", type=float, default=None, help="map resolution (m), default 0.2")
    ap.add_argument("--icp-mode", choices=["point", "plane"], default=None,
                    help="odometry ICP mode, default plane")
    ap.add_argument("--skip", type=int, default=None, help="clouds skipped between scans, default 0")
    ap.add_argument("--keyframe-distance", type=float, default=None, help="default 0.3")
    ap.add_argument("--window", type=int, default=None,
                    help="keyframes between graph solves, default 4")
    ap.add_argument("--max-points", type=int, default=None, help="filtered scan capacity, default 8192")
    ap.add_argument("--max-raw-points", type=int, default=None,
                    help="raw scan capacity, default 131072")
    ap.add_argument("--max-map-points", type=int, default=None,
                    help="map capacity, default 262144")
    ap.add_argument("--max-keyframes", type=int, default=None,
                    help="keyframe store capacity (edges 4x), default 512")
    ap.add_argument("--verbosity", type=int, default=None, help="0 silent, 1 info, 2 debug; default 1")
    ap.add_argument("--extrinsic", type=str, default=None,
                    help="laser pose in the robot frame, 'x,y,z' or 'x,y,z,qw,qx,qy,qz', "
                    "applied to every scan at ingest")
    ap.add_argument("--rate", type=float, default=10.0, help="synthetic scan rate (Hz)")
    ap.add_argument("--deferred-optimize", action="store_true",
                    help="run the graph solve beside the stream (pipeline/deferred.py)")
    ap.add_argument("--config", type=str, default=None,
                    help="load the SlamConfig from this YAML file (needs PyYAML); "
                    "explicit flags override it")
    ap.add_argument("--scan-cache", type=str, default=None,
                    help="(--kitti-proxy) keep the rendered scans in this .npz and reuse them")
    ap.add_argument("--no-proxy-physics", action="store_true",
                    help="(--kitti-proxy) the idealized render: no motion distortion, range "
                    "noise, dropout or traffic")
    ap.add_argument("--deskew", action="store_true",
                    help="(--kitti-proxy) undo the motion distortion at ingest with a noisy-INS "
                    "relative-motion measurement")
    ap.add_argument("--deskew-rounds", type=int, default=None,
                    help="in-loop de-skew without an INS (config.deskew_rounds)")
    ap.add_argument("--deskew-mode", choices=["coupled", "joint", "alternate"], default=None,
                    help="in-loop de-skew estimator (config.deskew_mode)")
    ap.add_argument("--deskew-prior-weight", type=float, default=None,
                    help="information of the sweep-twist prior (config.deskew_prior_weight)")
    ap.add_argument("--deskew-prior-huber", type=float, default=None,
                    help="Huber scale of the twist prior (config.deskew_prior_huber)")
    ap.add_argument("--deskew-free-twist", action="store_true",
                    help="(coupled) free the source sweep twist (config.deskew_free_twist)")
    ap.add_argument("--deskew-auto-prior", choices=["on", "off"], default=None,
                    help="(free twist) latched straight/turn prior (config.deskew_auto_prior)")
    ap.add_argument("--keyframe-eviction", choices=["marginalize", "none"], default=None,
                    help="full keyframe store: marginalize the most redundant keyframe "
                    "(default) or stop adding (config.keyframe_eviction)")
    ap.add_argument("--adaptive-information", action="store_true",
                    help="sequential-edge information from the registration's GN Hessian "
                    "(config.adaptive_information)")
    ap.add_argument("--chunk", type=int, default=1,
                    help="scans per slam.run_scans call (a partial last chunk is padded)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, which fails without a card; "
                    "the CPU needs --device cpu)")
    ap.add_argument("--out", type=str, default=None, help="write the trajectory .npz")
    ap.add_argument("--summary-out", type=str, default=None,
                    help="also write the summary JSON to this file")
    ap.add_argument("--save-state", type=str, default=None,
                    help="checkpoint the final state to this .npz (resume with --resume)")
    ap.add_argument("--resume", type=str, default=None,
                    help="resume from a --save-state checkpoint (the same capacities); the "
                    "map is re-rendered from the keyframes")
    ap.add_argument("--trace", type=str, default=None,
                    help="write a torch.profiler (Chrome/Perfetto) trace of the run to this directory")
    ap.add_argument("--debug-dump", type=str, default=None,
                    help="write the products of rejected and unrefined scans to this directory "
                    "(needs --chunk 1; one host read per scan)")
    ap.add_argument("--html", type=str, default=None,
                    help="write the standalone viewer (map, trajectories, pose graph) to this file")
    ap.add_argument("--html-every", type=int, default=0,
                    help="with --html: rewrite the viewer every N scans during the run "
                    "(needs --chunk 1)")
    return ap


def _source(args, cfg: SlamConfig, log: Logger):
    """(scans, ground truth or None, initial pose or None, loader, title)."""
    physics = args.kitti_proxy and not args.no_proxy_physics
    if args.kitti_proxy:
        if args.scan_cache:
            scans, gt = cached_proxy_source(args.scan_cache, cfg, args.poses, args.rate,
                                            physics, args.deskew, start=args.start, log=log)
        else:
            if args.start:
                raise SystemExit("--start with --kitti-proxy requires --scan-cache")
            scans, gt = kitti_proxy_source(cfg, args.poses, args.rate, physics, args.deskew)
        return scans, gt, (gt[0][0], gt[1][0]), "synthetic", "KITTI-proxy"
    if args.synthetic:
        scans, gt = synthetic_source(cfg, args.poses, args.rate)
        return scans, gt, (gt[0][0], gt[1][0]), "synthetic", "synthetic"
    from icpslam_tpu_torch.io import kitti, native_loader

    native = native_loader.available()
    if not native:
        log.warn("native scan loader unavailable (no g++ or the build failed); "
                 "reading with the Python reader")
    loader = "native" if native else "python"
    if args.watch:
        from icpslam_tpu_torch.io import live

        log.info(f"watching {args.watch} for incoming scans")
        scans = live.directory_stream(args.watch, cfg.max_raw_points, with_stamps=True,
                                      use_native=native, logger=log)
        return scans, None, None, loader, "live watch"
    scans = native_loader.scan_stream(args.kitti, args.seq, capacity=cfg.max_raw_points,
                                      start=args.start, end=args.end, with_stamps=True,
                                      use_native=native)
    gt = None
    try:
        t, q = kitti.ground_truth_velodyne(args.kitti, args.seq)
        gt = (t[args.start:args.end], q[args.start:args.end])
    except (FileNotFoundError, OSError):
        log.warn("no ground-truth poses found; skipping ATE")
    return scans, gt, None, loader, f"KITTI {args.seq}"


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: torch.cuda.is_available() is False; "
            "pass --device cpu to run on the CPU"
        )
    physics = args.kitti_proxy and not args.no_proxy_physics
    if args.deskew and not physics:
        raise SystemExit("--deskew undoes the motion distortion of the physics render; "
                         "it does nothing without it (--no-proxy-physics, --synthetic, --kitti)")
    if args.chunk < 1:
        raise SystemExit("--chunk must be at least 1")
    if args.debug_dump and args.chunk != 1:
        raise SystemExit("--debug-dump requires --chunk 1")
    if args.html and args.html_every and args.chunk != 1:
        raise SystemExit("--html-every requires --chunk 1")

    cfg = build_config(args)
    log = Logger(level=cfg.verbosity)
    scans, gt, init, loader, title = _source(args, cfg, log)
    cfg = _apply_run_flags(cfg, args, log)
    if args.debug_dump:
        cfg = cfg.replace(collect_debug=True)
    backend = None
    if args.deferred_optimize:
        cfg = cfg.replace(defer_optimization=True)
        # a chunk calls the hook once, so its cadence is already in
        # window-sized units there (JAX runner.py:960-971)
        backend = deferred.DeferredBackend(
            cfg, check_every=cfg.keyframes_window if args.chunk == 1 else 1)
    post_step = backend.maybe_launch_or_fold if backend is not None else None

    state, resumed = None, {}
    if args.resume:
        from icpslam_tpu_torch.utils import checkpoint

        state = checkpoint.load(args.resume, slam.init_state(cfg, device=args.device))
        state = checkpoint.rerender_map(state, cfg)
        resumed = dict(resumed_keyframes=int(state.keyframes.count),
                       resumed_map_size=int(map_backend.total_size(state.map)))
        log.info(f"resumed {resumed['resumed_keyframes']} keyframes from {args.resume} "
                 f"(map re-rendered: {resumed['resumed_map_size']} points)")
    init_pose = None
    if init is not None and state is None:
        init_pose = Pose(t=torch.from_numpy(init[0]).to(args.device),
                         q=torch.from_numpy(init[1]).to(args.device))

    snapshot_fn = None
    if args.html and args.html_every:
        from icpslam_tpu_torch.viz import html as viz_html

        def snapshot_fn(i, st, traj):
            viz_html.export_state_html(args.html, st, trajectory=traj, config=cfg,
                                       title=f"icpslam_tpu_torch — live (scan {i + 1})")
            log.info(f"scan {i + 1}: refreshed live viewer {args.html}")

    with profiling.trace(args.trace) if args.trace else contextlib.nullcontext():
        res = run_slam(scans, cfg, init_pose, args.device, post_step=post_step,
                       chunk=args.chunk, state=state, logger=log, debug_dir=args.debug_dump,
                       snapshot_every=args.html_every if snapshot_fn else 0,
                       snapshot_fn=snapshot_fn)
    extra = {}
    if backend is not None:
        res.state = backend.flush(res.state)
        extra = dict(deferred_launched=backend.num_launched, deferred_folded=backend.num_folded)
        log.info(f"deferred back end: {backend.num_launched} solves launched, "
                 f"{backend.num_folded} folded")
    n = res.records.shape[0]
    log.info(f"processed {n} scans in {res.wall_time:.2f}s")
    gt_matches = gt is not None and gt[0].shape[0] == n and n > 1
    summary = {**res.summary(), **(evaluate(res, gt) if gt_matches else {}), **extra, **resumed,
               "loader": loader, "chunk": args.chunk, "device": args.device,
               "deskew_rounds": cfg.deskew_rounds, "deskew_mode": cfg.deskew_mode,
               "deskew_free_twist": cfg.deskew_free_twist}
    if gt_matches:
        print(f"ATE {summary['ate_m']:.4f} m  RPE {summary['rpe_t']:.4f} m / "
              f"{summary['rpe_r']:.5f} rad")
    print(json.dumps(summary))
    if args.summary_out:
        workload = ("kitti_proxy" if args.kitti_proxy else "synthetic" if args.synthetic
                    else "live_watch" if args.watch else f"kitti_{args.seq}")
        with open(args.summary_out, "w") as f:
            json.dump({**summary, "workload": workload, "poses": n,
                       "backend": torch.device(args.device).type}, f, indent=1)
        log.info(f"wrote summary to {args.summary_out}")
    if args.save_state:
        from icpslam_tpu_torch.utils import checkpoint

        checkpoint.save(args.save_state, res.state)
        log.info(f"checkpointed final state to {args.save_state}")
    if args.out:
        np.savez(args.out, t=res.records[:, :3], q=res.records[:, 3:7],
                 **({"gt_t": gt[0], "gt_q": gt[1]} if gt is not None else {}))
        log.info(f"wrote trajectory to {args.out}")
    if args.html:
        from icpslam_tpu_torch.viz import html as viz_html

        gt_pose = (Pose(t=torch.from_numpy(gt[0]), q=torch.from_numpy(gt[1]))
                   if gt_matches else None)
        viz_html.export_state_html(args.html, res.state, trajectory=res.trajectory, config=cfg,
                                   ground_truth=gt_pose, title="icpslam_tpu_torch — " + title)
        log.info(f"wrote viewer to {args.html}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
