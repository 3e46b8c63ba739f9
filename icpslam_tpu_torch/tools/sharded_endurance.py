"""Sharded-map endurance drive (port of the JAX package's
``tools/sharded_endurance.py``).

Drives 500 scans through the streaming sharded pipeline (``slam_step``
with ``map_backend='sharded'`` over a mesh of 8 shards, the windowed solve
edge-sharded by ``dist-pcg``) with every capacity pressure at once:

- 512 map slots per shard, so shards saturate and count their overflow;
- 48 keyframes, so marginalization fires on every keyframe once the store
  is full, and nodes and loop closures keep coming.

The configuration is the JAX tool's ``tiny_config`` exactly: the small
stores are the point (the full-width sharded path is ``chip_smoke.py``
phase 20). Parity: the same stream through the one-device voxel map at
the same total capacity (4,096 slots) must land in the same drift
envelope.

The mesh is ``make_mesh(8)`` without a process group: one process holds
all 8 shards on the device and reduces over them (``parallel/mesh.py``).
The JAX tool's XLA:CPU workarounds are not needed and not ported: the
8-virtual-device environment set-up, the block on the state every 8 steps
(it bounds XLA:CPU's queue of in-process collectives, which deadlock
under a deep queue) and the host-side stacking of the trajectory (an
eager stack over multi-device outputs could abort that rendezvous). The
port's shards are a tensor axis of one process, and its steps run in
order on one stream.

    python -m icpslam_tpu_torch.tools.sharded_endurance --scans 500 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from icpslam_tpu_torch.tools._common import (add_device_flag, artifact_path, card, check_device,
                                             launch_counts, reset_launch_counts, sync,
                                             write_artifact)

SHARDS = 8


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=500)
    ap.add_argument("--out", type=str, default=artifact_path("sharded_endurance.json"))
    add_device_flag(ap)
    return ap


def base_config() -> dict:
    """The JAX tool's overrides of ``tiny_config``."""
    from icpslam_tpu_torch.config import IcpConfig

    return dict(
        voxel_leaf_size=0.3,
        map_resolution=0.3,
        icp_odometry=IcpConfig(mode="plane", max_iterations=8),
        icp_mapping=IcpConfig(mode="point", max_iterations=15),
        max_points=1024,
        max_raw_points=2048,
        max_keyframes=48,        # ~3 laps want >100 keyframes: evictions
        keyframe_distance=0.25,
        keyframe_protect_recent=8,
        max_edges=256,
        keyframes_window=4,
        reset_map_on_optimize=False,   # let the map actually fill
        enable_loop_closure=True,
    )


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    dev = check_device(args.device)

    from icpslam_tpu_torch.cloud.pointcloud import PointCloud
    from icpslam_tpu_torch.config import tiny_config
    from icpslam_tpu_torch.eval import metrics
    from icpslam_tpu_torch.geometry.se3 import Pose
    from icpslam_tpu_torch.io import synthetic
    from icpslam_tpu_torch.mapping import backend as map_backend
    from icpslam_tpu_torch.parallel import mesh as mesh_lib
    from icpslam_tpu_torch.pipeline import slam

    base = base_config()
    n_laps = max(3.0, args.scans / 120.0)
    world = synthetic.make_room_world(seed=0, n_points=12000)
    gt_t, gt_q = synthetic.make_loop_trajectory(n_poses=args.scans, radius=5.0, laps=n_laps)
    gt = Pose(t=torch.from_numpy(gt_t), q=torch.from_numpy(gt_q))

    def stream():
        return synthetic.scan_stream(
            world, (gt_t, gt_q), capacity=2048, max_range=12.0, n_points=1200, noise=0.01,
        )

    def drive(cfg, mesh=None, tag=""):
        init = Pose(t=gt.t[0].to(dev), q=gt.q[0].to(dev))
        st = slam.init_state(cfg, initial_pose=init, device=dev, mesh=mesh)
        ts, qs = [], []
        reset_launch_counts()
        sync(dev)
        t0 = time.perf_counter()
        for points, mask in stream():
            scan = PointCloud(torch.from_numpy(points).to(dev), torch.from_numpy(mask).to(dev))
            st, out = slam.slam_step(st, scan, cfg, mesh=mesh)
            ts.append(out.pose_map.t)
            qs.append(out.pose_map.q)
        sync(dev)
        wall = time.perf_counter() - t0
        launches = launch_counts()
        traj = Pose(t=torch.stack(ts), q=torch.stack(qs))
        ate, _ = metrics.ate(traj, gt, align=True)
        return st, {
            "tag": tag,
            "scans": args.scans,
            "wall_s": round(wall, 1),
            "ate_m": round(float(ate), 4),
            "keyframes": int(st.keyframes.count),
            "keyframe_evictions": int(st.keyframes.evictions),
            "loop_closures": int(st.num_loop_closures),
            "optimizations": int(st.num_optimizations),
            "edges": int(st.edges.count),
            "edge_overflow": int(st.edges.overflow),
            "map_size": int(map_backend.total_size(st.map)),
            "map_overflow": int(map_backend.total_overflow(st.map)),
            "poses_finite": bool(torch.isfinite(traj.t).all() and torch.isfinite(traj.q).all()),
            "launches": launches,
        }

    # --- sharded drive: 8 shards, per-shard capacity sized to saturate --
    mesh = mesh_lib.make_mesh(SHARDS, device=dev)
    cfg_s = tiny_config(**base, map_backend="sharded", map_shards=SHARDS,
                        max_map_points=512,
                        graph_linear_solver="dist-pcg")
    st_s, rs = drive(cfg_s, mesh=mesh, tag=f"sharded_{SHARDS}shards")
    per_shard = {
        "sizes": st_s.map.size.cpu().tolist(),
        "overflow": st_s.map.overflow.cpu().tolist(),
    }

    # --- one-device parity run at the same total capacity ---------------
    cfg_v = tiny_config(**base, map_backend="voxel", max_map_points=4096)
    _, rv = drive(cfg_v, tag="single_device_voxel")

    artifact = {
        "metric": "sharded_endurance",
        "backend": f"{dev.type} mesh of {SHARDS} shards in one process (no process group)",
        "sharded": {**rs, "per_shard": per_shard},
        "single_device": rv,
        "parity_ate_delta_m": round(abs(rs["ate_m"] - rv["ate_m"]), 4),
        "note": "streaming sharded pipeline under simultaneous capacity pressure: shard "
        "overflow counted, keyframe marginalization recycling slots, dist-pcg windowed "
        "solves over the mesh's shards. Parity = same drift envelope as the one-device "
        "voxel run at equal total capacity",
        "card": card(dev),
    }
    write_artifact(args.out, artifact)
    print(json.dumps({
        "sharded_endurance": "ok",
        "sharded_ate": rs["ate_m"],
        "single_ate": rv["ate_m"],
        "evictions": rs["keyframe_evictions"],
        "map_overflow": rs["map_overflow"],
        "out": args.out,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
