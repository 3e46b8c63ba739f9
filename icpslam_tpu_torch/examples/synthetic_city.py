"""End to end: the whole SLAM pipeline on a synthetic city block along a
figure eight, which crosses itself, so loop closures fire mid-sequence
(port of the JAX package's ``examples/synthetic_city.py``).

Exports every product the reference shows in rviz as files: the
trajectory and the ground truth (TUM), the map re-rendered from the
keyframes (PLY), the pose graph (JSON), the checkpoint (``.npz``, which
either package loads) and the standalone viewer (HTML). The run's summary
is one line of JSON, with the kernels' launches.

    python -m icpslam_tpu_torch.examples.synthetic_city [--cpu] [--poses 120] [--out-dir out/]

Without ``--cpu`` it runs on the CUDA card, and fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def config():
    """The JAX example's configuration."""
    from icpslam_tpu_torch.config import IcpConfig, SlamConfig

    return SlamConfig(
        voxel_leaf_size=0.25,
        map_resolution=0.25,
        icp_odometry=IcpConfig(mode="plane", max_iterations=10),
        icp_mapping=IcpConfig(mode="point", max_iterations=20),
        max_points=8192,
        max_raw_points=16384,
        max_map_points=131072,
        max_keyframes=256,
        max_edges=1024,
        keyframe_distance=0.5,
        loop_closure_radius=4.0,
        loop_closure_min_id_gap=10,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--poses", type=int, default=120)
    ap.add_argument("--scan-points", type=int, default=12000)
    ap.add_argument("--out-dir", type=str, default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from icpslam_tpu_torch.eval import metrics
    from icpslam_tpu_torch.geometry.se3 import Pose
    from icpslam_tpu_torch.io import synthetic
    from icpslam_tpu_torch.io.runner import run_slam
    from icpslam_tpu_torch.tools._common import card, launch_counts
    from icpslam_tpu_torch.utils import checkpoint
    from icpslam_tpu_torch.utils.logging import Logger
    from icpslam_tpu_torch.viz import export as viz

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA card (torch.cuda.is_available() is False); "
                         "pass --cpu to run on the CPU")
    dev = torch.device("cpu" if args.cpu else "cuda")
    cfg = config()
    log = Logger(level=1)

    world = synthetic.make_street_grid_world(seed=0, n_points=80000)
    gt_t, gt_q = synthetic.make_figure_eight_trajectory(n_poses=args.poses)
    gt = Pose(t=torch.from_numpy(gt_t), q=torch.from_numpy(gt_q))
    # stamped 1 s apart from 0: the JAX example feeds no stamps, and its
    # state then counts scans
    scans = synthetic.scan_stream(
        world, (gt_t, gt_q), capacity=cfg.max_raw_points, max_range=18.0,
        n_points=args.scan_points, noise=0.02, seed=0, rate_hz=1.0,
    )
    log.info(f"running {args.poses} scans over a figure-eight "
             f"({float(np.ptp(gt_t[:, 0])):.0f} m wide)")

    init = Pose(t=gt.t[0].to(dev), q=gt.q[0].to(dev))
    res = run_slam(scans, cfg, initial_pose=init, device=dev, logger=log)
    n = res.trajectory.t.shape[0]

    ate_rmse, _ = metrics.ate(res.trajectory, gt, align=True)
    t_rpe, r_rpe = metrics.rpe(res.trajectory, gt)
    summary = {
        "scans": n,
        "wall_s": round(res.wall_time, 2),
        "scans_per_sec_incl_compile": round(n / res.wall_time, 2),
        "keyframes": int(res.state.keyframes.count),
        "loop_closures": int(res.state.num_loop_closures),
        "optimizations": int(res.state.num_optimizations),
        "edge_overflow": int(res.state.edges.overflow),
        "ate_m": round(ate_rmse, 4),
        "rpe_t_m": round(t_rpe, 4),
        "rpe_r_rad": round(r_rpe, 5),
        "launches": launch_counts(),
        "card": card(dev),
    }

    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        viz.export_trajectory_tum(os.path.join(args.out_dir, "trajectory.txt"), res.trajectory)
        viz.export_trajectory_tum(os.path.join(args.out_dir, "ground_truth.txt"), gt)
        viz.export_pose_graph_json(os.path.join(args.out_dir, "graph.json"), res.state)
        rendered = checkpoint.rerender_map(res.state, cfg)
        n_pts = viz.save_ply(os.path.join(args.out_dir, "map.ply"),
                             (rendered.map.points, rendered.map.occupancy_mask()))
        checkpoint.save(os.path.join(args.out_dir, "state.npz"), res.state)
        from icpslam_tpu_torch.viz import html as viz_html

        viz_html.export_state_html(
            os.path.join(args.out_dir, "viewer.html"),
            rendered,
            trajectory=res.trajectory,
            ground_truth=gt,
            title="icpslam_tpu_torch — synthetic city",
        )
        summary["map_points"] = n_pts
        log.info(f"exported trajectory, graph, {n_pts}-point map, checkpoint, "
                 f"viewer.html to {args.out_dir}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
