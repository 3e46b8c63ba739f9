"""The fused step's budget by ablation (port of the JAX package's
``tools/probe_step_budget.py``).

Times the whole ``slam_step`` with pieces of the pipeline switched off
by config, so that each difference from ``full`` is that piece's share of
the step: ``no_loop_closure``, ``no_scan_to_map``, ``no_eviction_branch``,
``odometry_point_mode`` (point-to-point ICP in both stages, so no K2
covariances), ``mapping_requery_1`` and ``graph_noninc``. Each variant
warms up on the stream's first 3 scans (``tools/streams.py``), then
drives the other 30 three times from the same warmed state; one line of
JSON per variant: JAX's ``variant``, ``ms_per_scan`` (the median pass)
and ``spread`` (the other two), and the port's host syncs and K1/K2
launches per scan. The stream is synchronized at the ends of each pass.

Before the variants one untimed pass of ``full`` over the whole stream
takes the process's first-use costs (the kernels' load, the CUDA-graph
captures of the solves, the allocator's growth): JAX compiles each
variant whole in its first warm-up call, where the port captures a
solve at its first use, which 3 warm-up scans do not reach.

    python -m icpslam_tpu_torch.tools.probe_step_budget [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from icpslam_tpu_torch.tools._common import (add_device_flag, card, check_device, launch_counts,
                                             reset_launch_counts, sync)
from icpslam_tpu_torch.tools.probe_scan_to_map import base_config

WARMUP = 3
SCANS = 30
PASSES = 3


def variants(base=None):
    """``[(tag, config)]``: JAX's seven variants, in its order."""
    base = base or base_config()
    return [
        ("full", base),
        ("no_loop_closure", base.replace(enable_loop_closure=False)),
        ("no_scan_to_map", base.replace(enable_scan_to_map=False)),
        ("no_eviction_branch", base.replace(keyframe_eviction="none")),
        ("odometry_point_mode", base.replace(
            icp_odometry=dataclasses.replace(base.icp_odometry, mode="point"),
            icp_mapping=dataclasses.replace(base.icp_mapping, mode="point"),
        )),
        ("mapping_requery_1", base.replace(mapping_requery_rounds=1)),
        ("graph_noninc", base.replace(graph_incremental=False)),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = check_device(args.device)

    from icpslam_tpu_torch.pipeline import slam
    from icpslam_tpu_torch.tools.streams import make_stream, pose_at
    from icpslam_tpu_torch.utils.sync import to_host

    base = base_config()
    scans, gt = make_stream(base, SCANS, WARMUP, dev)

    def timed(tag, cfg):
        state = slam.init_state(cfg, pose_at(gt, 0, dev), device=dev)
        for i in range(WARMUP):
            state, _ = slam.slam_step(state, scans[i], cfg)
        sync(dev)
        runs = []
        syncs0 = to_host.count
        reset_launch_counts()
        for _ in range(PASSES):
            st = state
            t0 = time.perf_counter()
            for i in range(WARMUP, len(scans)):
                st, _ = slam.slam_step(st, scans[i], cfg)
            sync(dev)
            runs.append((time.perf_counter() - t0) / (len(scans) - WARMUP) * 1e3)
        n = PASSES * (len(scans) - WARMUP)
        launches = launch_counts()
        runs.sort()
        line = {"variant": tag, "ms_per_scan": round(runs[1], 3),
                "spread": [round(runs[0], 3), round(runs[2], 3)],
                "host_syncs_per_scan": (to_host.count - syncs0) / n,
                "k1_launches_per_scan": launches["nn1"] / n,
                "k2_launches_per_scan": launches["knn"] / n}
        print(json.dumps(line), flush=True)
        return runs[1]

    st = slam.init_state(base, pose_at(gt, 0, dev), device=dev)
    for scan in scans:
        st, _ = slam.slam_step(st, scan, base)
    sync(dev)
    full = None
    for tag, cfg in variants(base):
        ms = timed(tag, cfg)
        full = ms if full is None else full
    print(json.dumps({"variant": "full_baseline_scans_per_sec",
                      "value": round(1000.0 / full, 1), "card": card(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
