"""Probe the scan-to-map stage: measured ICP iterations and the time per
knob (port of the JAX package's ``tools/probe_scan_to_map.py``).

A map is built from 6 voxel-filtered scans of the probes' stream
(``tools/streams.py``), then ``mapping/scan_to_map.refine_and_grow`` is
timed over 8 calls against it for each knob: the default (30 mapping
iterations), ``max_iterations`` 15, 10, 6 and 4, and
``transformation_epsilon`` 1e-3. One line of JSON per knob: JAX's
``probe``, ``ms``, ``iters`` and ``map_fill``, and the port's host syncs
and K1/K2 launches per call. The stream is synchronized once before and
once after the timed loop, and the iteration counts are read after it: a
read inside the loop would be one more sync per call.

    python -m icpslam_tpu_torch.tools.probe_scan_to_map [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from icpslam_tpu_torch.tools._common import (add_device_flag, card, check_device, launch_counts,
                                             reset_launch_counts, sync)

CALLS = 8


def base_config():
    """JAX's probe configuration (8,192 filtered and 32,768 raw points,
    plane odometry with 10 iterations)."""
    from icpslam_tpu_torch.config import IcpConfig, SlamConfig

    return SlamConfig(
        voxel_leaf_size=0.2,
        icp_odometry=IcpConfig(mode="plane", max_iterations=10),
        max_points=8192,
        max_raw_points=32768,
    )


def variants(cfg=None):
    """``[(tag, config)]``: the knobs JAX's probe times, in its order."""
    cfg = cfg or base_config()
    out = [("default_30iter", cfg)]
    for mi in (15, 10, 6, 4):
        out.append((f"max_iter_{mi}", cfg.replace(
            icp_mapping=dataclasses.replace(cfg.icp_mapping, max_iterations=mi))))
    # looser epsilon: exits earlier at equal budget
    out.append(("eps_1e-3", cfg.replace(
        icp_mapping=dataclasses.replace(cfg.icp_mapping, transformation_epsilon=1e-3))))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = check_device(args.device)

    import torch

    from icpslam_tpu_torch.cloud.voxel import voxel_downsample
    from icpslam_tpu_torch.mapping import backend as map_backend
    from icpslam_tpu_torch.mapping import scan_to_map
    from icpslam_tpu_torch.tools.streams import make_stream, pose_at
    from icpslam_tpu_torch.utils.sync import to_host

    cfg = base_config()
    scans, gt = make_stream(cfg, 12, 0, dev)
    filtered = [voxel_downsample(s, cfg.voxel_leaf_size, cfg.max_points)[0] for s in scans[:6]]

    def probe(tag, cfg):
        def refine(m, c, p, empty):
            return scan_to_map.refine_and_grow(m, c, p, cfg, map_empty=empty)

        st = map_backend.empty(cfg, device=dev)
        rargs = []
        for i, c in enumerate(filtered):
            rargs.append((st, c, pose_at(gt, i, dev), int(map_backend.total_size(st)) == 0))
            st = refine(*rargs[-1]).map
        out = refine(*rargs[1])  # warm
        sync(dev)
        syncs0 = to_host.count
        reset_launch_counts()
        outs = []
        t0 = time.perf_counter()
        for k in range(CALLS):
            out = refine(*rargs[1 + k % (len(rargs) - 1)])
            outs.append(out.icp_iterations)
        sync(dev)
        ms = (time.perf_counter() - t0) / CALLS * 1000.0
        launches = launch_counts()
        syncs = (to_host.count - syncs0) / CALLS
        iters = [int(x) for x in torch.stack(outs).cpu()]
        line = {
            "probe": tag, "ms": round(ms, 3),
            "iters": iters,
            "map_fill": int(map_backend.total_size(st)),
            "max_iterations": cfg.icp_mapping.max_iterations,
            "host_syncs_per_call": syncs,
            "k1_launches_per_call": launches["nn1"] / CALLS,
            "k2_launches_per_call": launches["knn"] / CALLS,
        }
        print(json.dumps(line), flush=True)
        return line

    lines = [probe(tag, c) for tag, c in variants(cfg)]
    print(json.dumps({"probe_scan_to_map": "ok", "card": card(dev),
                      "ms": {l["probe"]: l["ms"] for l in lines}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
