"""Streaming SLAM with the map spatially sharded (port of the JAX
package's ``examples/sharded_streaming.py``).

The reference holds one global octree in one process
(``octree_mapper.cpp:19``); here each of D shards owns the voxel blocks
its spatial hash assigns it: the insert routes points with no
communication, the NN query reduces over the shards (min, then sum), and
the map's total capacity grows with D. ``--devices`` is D; by default the
mesh's world size, which is 1 in one process (JAX's default, all devices,
is 1 on one card). One process holds all D shards on its device
(``parallel/mesh.py``); the JAX example's XLA:CPU workarounds (a block on
the state every 8 steps, the host-side stacking of the trajectory) have
nothing to work around here.

    python -m icpslam_tpu_torch.examples.sharded_streaming --poses 16 --devices 8 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from icpslam_tpu_torch.tools._common import (add_device_flag, card, check_device, launch_counts,
                                             reset_launch_counts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--poses", type=int, default=16)
    ap.add_argument("--devices", type=int, default=None,
                    help="shard count D (default: the mesh's world size)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = check_device(args.device)

    from icpslam_tpu_torch.cloud.pointcloud import PointCloud
    from icpslam_tpu_torch.config import IcpConfig, tiny_config
    from icpslam_tpu_torch.eval import metrics
    from icpslam_tpu_torch.geometry.se3 import Pose
    from icpslam_tpu_torch.io import synthetic
    from icpslam_tpu_torch.parallel import mesh as mesh_lib
    from icpslam_tpu_torch.parallel import sharded_map
    from icpslam_tpu_torch.pipeline import slam

    mesh = mesh_lib.make_mesh(args.devices, device=dev)
    n_dev = mesh.size
    cfg = tiny_config(
        voxel_leaf_size=0.3,
        map_resolution=0.3,
        icp_odometry=IcpConfig(mode="plane", max_iterations=8),
        icp_mapping=IcpConfig(mode="point", max_iterations=15),
        max_points=1024,
        max_raw_points=2048,
        max_map_points=8192,   # per shard: the total capacity grows with D
        max_keyframes=64,
        max_edges=256,
        map_backend="sharded",
        map_shards=n_dev,
    )

    world = synthetic.make_room_world(seed=0, n_points=12000)
    gt_t, gt_q = synthetic.make_loop_trajectory(n_poses=args.poses, radius=5.0, laps=0.9)
    gt = Pose(t=torch.from_numpy(gt_t), q=torch.from_numpy(gt_q))
    state = slam.init_state(cfg, initial_pose=Pose(t=gt.t[0].to(dev), q=gt.q[0].to(dev)),
                            device=dev, mesh=mesh)
    ts, qs, sizes = [], [], []
    reset_launch_counts()
    for points, mask in synthetic.scan_stream(
        world, (gt_t, gt_q), capacity=cfg.max_raw_points, max_range=12.0, n_points=1200,
    ):
        scan = PointCloud(torch.from_numpy(points).to(dev), torch.from_numpy(mask).to(dev))
        state, out = slam.slam_step(state, scan, cfg, mesh=mesh)
        ts.append(out.pose_map.t)
        qs.append(out.pose_map.q)
        sizes.append(torch.cat([state.map.size, sharded_map.total_size(state.map, mesh)[None]]))
    traj = Pose(t=torch.stack(ts), q=torch.stack(qs))
    ate, _ = metrics.ate(traj, gt, align=False)
    per_shard = state.map.size.cpu()
    # a solve clears the map (``reset_map_on_optimize``; the next scans grow
    # it again), so the run's largest map is reported too: its step, its
    # shards' sizes and the mesh's total
    sizes = torch.stack(sizes).cpu()
    peak = int(sizes[:, -1].argmax())
    print(json.dumps({
        "devices": n_dev,
        "scans": args.poses,
        "ate_m": round(float(ate), 4),
        "keyframes": int(state.keyframes.count),
        "loop_closures": int(state.num_loop_closures),
        "map_voxels_total": int(per_shard.sum()),
        "map_voxels_per_shard": per_shard.tolist(),
        "peak_map_step": peak,
        "peak_map_voxels_total": int(sizes[peak, -1]),
        "peak_map_voxels_per_shard": sizes[peak, :-1].tolist(),
        "launches": launch_counts(),
        "card": card(dev),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
