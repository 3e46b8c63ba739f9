"""Mission-scale real-loader artifact (port of the JAX package's
``tools/kitti_tree_run.py``): write a full KITTI odometry tree from the
rendered physics-proxy sweeps of a scan cache and drive it through
``runner --kitti`` (the native prefetching loader, 4-column bins, a
non-trivial ``Tr``, times.txt, cam0 poses: the path a mounted KITTI
dataset takes).

The cache is the runner's ``--scan-cache`` (``tools/endurance.py`` renders
one), so the sweeps carry the full sensor physics (motion smear, range
noise, dropout, traffic); the run turns on the no-INS coupled de-skew. The
tree is written by the port's ``io/kitti.write_tree`` (byte for byte as
the JAX package writes it) into a temporary directory unless ``--root``
names one. The run must read it with the native loader: a summary that
says otherwise makes the tool fail.

    python -m icpslam_tpu_torch.tools.kitti_tree_run --cache /tmp/proxy2000.npz [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

from icpslam_tpu_torch.tools._common import (add_device_flag, artifact_path, card, check_device,
                                             run_runner, write_artifact)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cache", type=str,
                    default=os.path.join(tempfile.gettempdir(), "proxy2000.npz"))
    ap.add_argument("--out", type=str, default=artifact_path("kitti_tree_2000.json"))
    ap.add_argument("--scans", type=int, default=None,
                    help="limit (default: whole cache)")
    ap.add_argument("--root", type=str, default=None,
                    help="tree root (default: temp dir)")
    ap.add_argument("--extra-args", type=str, default="",
                    help="extra runner flags (space-separated)")
    add_device_flag(ap)
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    check_device(args.device)
    from icpslam_tpu_torch.io import kitti

    data = np.load(args.cache)
    n = int(data["gt_t"].shape[0])
    if args.scans:
        n = min(n, args.scans)
    root = args.root or tempfile.mkdtemp(prefix="kitti_tree_")
    gt = (data["gt_t"][:n], data["gt_q"][:n])
    kitti.write_tree(root, "99", (data[f"s{i}"] for i in range(n)), gt)
    print(f"wrote {n}-scan KITTI tree to {root}", flush=True)

    summary = run_runner(
        ["--kitti", root, "--seq", "99", "--end", str(n),
         "--max-keyframes", "1024",
         "--deskew-rounds", "1", "--deskew-free-twist"]
        + [a for a in args.extra_args.split() if a]
        + ["--device", args.device],
        timeout=3600,
    )
    summary.pop("_invocation_wall_s")
    if summary.get("loader") != "native":
        raise RuntimeError(f"the runner read the tree with the {summary.get('loader')} reader, "
                           "not the native loader (native/scanio.cpp failed to build?)")
    artifact = {
        "metric": "kitti_tree_real_loader",
        "scans": n,
        "tree_root": root,
        "deskew": "no-INS coupled + free twist",
        # the runner's summary, with its "loader" ("native": io/kitti.py +
        # native/scanio.cpp prefetcher, 4-col bins, Tr, times.txt stamps)
        **summary,
        "card": card(args.device),
        "backend": f"{args.device} (icpslam_tpu_torch.io.runner --kitti)",
    }
    write_artifact(args.out, artifact)
    print(json.dumps({"kitti_tree": "ok", "scans": n,
                      "ate_m": summary.get("ate_m"), "out": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
