"""Minimal runner + CLI: stream synthetic scans through the port's ``slam_step``.

    python -m icpslam_tpu_torch.io.runner --synthetic --poses 20
    python -m icpslam_tpu_torch.io.runner --kitti-proxy --no-proxy-physics --poses 40
    python -m icpslam_tpu_torch.io.runner --kitti-proxy --no-proxy-physics --config my.yaml
    python -m icpslam_tpu_torch.io.runner --synthetic --poses 20 --deferred-optimize --trace DIR

``--synthetic`` is the room loop of the JAX runner (``icpslam_tpu/io/runner.py``)
with its default config; ``--kitti-proxy --no-proxy-physics`` the urban
proxy with the idealized render under ``kitti_config()``. ``--config``
loads the whole ``SlamConfig`` from YAML instead (PyYAML is needed only
then), as the JAX runner's flag does. The run prints ATE/RPE against the
ground truth and a one-line JSON summary, including the host syncs and
kernel launches per scan, the window, full and PCG graph solves, the
keyframe evictions and the edges dropped at a full edge store.
``--deferred-optimize`` runs the graph solve beside the stream
(``pipeline/deferred.py``; the summary adds ``deferred_launched`` and
``deferred_folded``), and ``--trace DIR`` writes a ``torch.profiler``
trace of the run there (``utils/profiling.py``). ``--device`` defaults
to ``cuda`` and fails without a card; the CPU runs
only with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from icpslam_tpu_torch.cloud import pointcloud as pc
from icpslam_tpu_torch.config import IcpConfig, SlamConfig, from_yaml, kitti_config
from icpslam_tpu_torch.eval import metrics
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.graph import pose_graph
from icpslam_tpu_torch.io import synthetic
from icpslam_tpu_torch.ops import nn as nn_ops
from icpslam_tpu_torch.ops import radius_stats
from icpslam_tpu_torch.pipeline import deferred, slam
from icpslam_tpu_torch.utils import profiling
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
    step_ms: List[float]      # per-scan step time, device work included
    host_syncs: List[int]     # counted host reads per scan
    launches: Dict[str, List[int]]  # per kernel of KERNELS, launches per scan (CUDA only)
    window_solves: List[int]  # incremental window solves per scan
    pcg_solves: List[int]     # graph solves by PCG per scan

    def summary(self) -> dict:
        r = self.records
        out = {
            "scans": int(r.shape[0]),
            "wall_time_s": self.wall_time,
            "accepted": int(r[:, 7].sum()),
            "processed": int(self.processed.sum()),
            "keyframes": int(self.state.keyframes.count),
            "edges": int(self.state.edges.count),
            "loop_closures": int(self.state.num_loop_closures),
            "optimizations": int(self.state.num_optimizations),
            "window_solves": int(sum(self.window_solves)),
            "full_solves": int(self.state.num_optimizations) - int(sum(self.window_solves)),
            "pcg_solves": int(sum(self.pcg_solves)),
            "evictions": int(self.state.keyframes.evictions),
            "edge_overflow": int(self.state.edges.overflow),
            "map_size": int(self.state.map.size),
            "host_syncs_per_scan": float(np.mean(self.host_syncs)) if self.host_syncs else 0.0,
        }
        for name, per_scan in self.launches.items():
            out[f"{name}_launches_per_scan"] = float(np.mean(per_scan)) if per_scan else 0.0
        if self.step_ms:
            a = np.asarray(self.step_ms[1:] or self.step_ms)
            out.update(step_ms_p50=float(np.median(a)), step_ms_p90=float(np.percentile(a, 90)),
                       first_step_ms=float(self.step_ms[0]))
        return out


def run_slam(
    scans: Iterable, config: SlamConfig, initial_pose: Optional[Pose], device,
    post_step: Optional[Callable[[slam.SlamState, slam.SlamOutput], slam.SlamState]] = None,
) -> RunResult:
    """Host loop over ``slam_step``. ``scans`` yields ``((points, mask), stamp)``
    numpy pairs. ``post_step(state, out) -> state`` is called after every
    step (the deferred back end's ``maybe_launch_or_fold``). Each step ends
    by synchronizing the current stream, so ``step_ms`` holds the step's
    own device work but not a solve running on another stream."""
    device = torch.device(device)
    state = slam.init_state(config, initial_pose, device=device)
    cuda = device.type == "cuda"
    packed, processed, step_ms, syncs, windows, pcgs = [], [], [], [], [], []
    launches = {name: [] for name in KERNELS}
    origin = None
    t0 = time.perf_counter()
    for (points, mask), stamp in scans:
        origin = stamp if origin is None else origin
        s0, w0 = to_host.count, pose_graph.optimize_window.calls
        p0 = pose_graph.optimize.pcg_solves
        k0 = {name: fn.launches for name, fn in KERNELS.items()}
        ts = time.perf_counter()
        cloud = pc.PointCloud(
            points=torch.from_numpy(points).to(device), mask=torch.from_numpy(mask).to(device)
        )
        state, out = slam.slam_step(state, cloud, config, stamp=stamp - origin)
        if post_step is not None:
            state = post_step(state, out)
        if cuda:
            torch.cuda.current_stream(device).synchronize()
        step_ms.append((time.perf_counter() - ts) * 1000.0)
        syncs.append(to_host.count - s0)
        windows.append(pose_graph.optimize_window.calls - w0)
        pcgs.append(pose_graph.optimize.pcg_solves - p0)
        for name, fn in KERNELS.items():
            launches[name].append(fn.launches - k0[name])
        packed.append(out.packed)
        processed.append(out.odom_out.processed)
    records = (
        to_host(torch.stack(packed)) if packed else np.zeros((0, 18), np.float32)
    )
    registered = to_host(torch.stack(processed)) if processed else np.zeros((0,), bool)
    traj = Pose(t=torch.from_numpy(records[:, :3]), q=torch.from_numpy(records[:, 3:7]))
    return RunResult(
        trajectory=traj, records=records, processed=registered, state=state,
        wall_time=time.perf_counter() - t0, step_ms=step_ms, host_syncs=syncs,
        launches=launches, window_solves=windows, pcg_solves=pcgs,
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


def kitti_proxy_source(config: SlamConfig, poses: int, rate: float):
    """The urban proxy, idealized render: (scan stream, ground truth)."""
    world = synthetic.make_urban_world(seed=0)
    gt = synthetic.make_urban_drive(n_poses=poses, rate_hz=rate)
    return synthetic.velodyne_stream(world, gt, capacity=config.max_raw_points, rate_hz=rate), gt


def evaluate(res: RunResult, gt) -> dict:
    gt_pose = Pose(t=torch.from_numpy(gt[0]), q=torch.from_numpy(gt[1]))
    ate_m, _ = metrics.ate(res.trajectory, gt_pose, align=True)
    rpe_t, rpe_r = metrics.rpe(res.trajectory, gt_pose)
    return {"ate_m": ate_m, "rpe_t": rpe_t, "rpe_r": rpe_r}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--synthetic", action="store_true", help="room loop")
    src.add_argument("--kitti-proxy", action="store_true", help="urban proxy (kitti_config)")
    ap.add_argument(
        "--no-proxy-physics", action="store_true",
        help="(--kitti-proxy) idealized render; required — the sensor-physics "
        "render needs de-skew, which is not ported yet",
    )
    ap.add_argument(
        "--config", type=str, default=None,
        help="load the SlamConfig from this YAML file (needs PyYAML) instead "
        "of the source's default config",
    )
    ap.add_argument("--poses", type=int, default=40)
    ap.add_argument("--rate", type=float, default=10.0)
    ap.add_argument(
        "--device", default="cuda",
        help="torch device (default: cuda, which fails without a card; "
        "the CPU needs --device cpu)",
    )
    ap.add_argument(
        "--deferred-optimize", action="store_true",
        help="run the graph solve beside the stream (pipeline/deferred.py)",
    )
    ap.add_argument("--trace", type=str, default=None,
                    help="write a torch.profiler (Chrome/Perfetto) trace of the run to this directory")
    ap.add_argument("--summary-out", type=str, default=None)
    args = ap.parse_args(argv)

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: torch.cuda.is_available() is False; "
            "pass --device cpu to run on the CPU"
        )
    if args.kitti_proxy:
        if not args.no_proxy_physics:
            raise NotImplementedError(
                "the sensor-physics proxy needs in-loop de-skew, which is not "
                "ported yet — ROADMAP.md Queue 1, 'de-skew'; pass --no-proxy-physics"
            )
        cfg = from_yaml(args.config) if args.config else kitti_config()
        stream, gt = kitti_proxy_source(cfg, args.poses, args.rate)
    else:
        cfg = from_yaml(args.config) if args.config else synthetic_config()
        stream, gt = synthetic_source(cfg, args.poses, args.rate)
    init = Pose(t=torch.from_numpy(gt[0][0]), q=torch.from_numpy(gt[1][0]))
    init = Pose(t=init.t.to(args.device), q=init.q.to(args.device))
    backend = None
    if args.deferred_optimize:
        cfg = dataclasses.replace(cfg, defer_optimization=True)
        # JAX runner.py:960-971 with one scan per step
        backend = deferred.DeferredBackend(cfg, check_every=cfg.keyframes_window)
    post_step = backend.maybe_launch_or_fold if backend is not None else None
    with profiling.trace(args.trace) if args.trace else contextlib.nullcontext():
        res = run_slam(stream, cfg, init, args.device, post_step=post_step)
    extra = {}
    if backend is not None:
        res.state = backend.flush(res.state)
        extra = dict(deferred_launched=backend.num_launched, deferred_folded=backend.num_folded)
    summary = {**res.summary(), **evaluate(res, gt), **extra, "device": args.device}
    print(f"ATE {summary['ate_m']:.4f} m  RPE {summary['rpe_t']:.4f} m / {summary['rpe_r']:.5f} rad")
    print(json.dumps(summary))
    if args.summary_out:
        with open(args.summary_out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
