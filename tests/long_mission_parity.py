"""The KITTI-proxy drive (idealized render) through the JAX package or the
port on the CPU, at a reduced size, for comparing their error profiles
over a second lap. Not collected by pytest: one run takes 15-35 minutes.

    JAX_PLATFORMS=cpu python tests/long_mission_parity.py jax 900
    python tests/long_mission_parity.py port 900

The config is ``kitti_config()`` with a 0.6 m voxel and map resolution,
4,096 filtered points, 65,536 raw and 65,536 map points. It prints the
final keyframe, loop-closure and edge counts, the RMS of the unaligned
position error, the error every 25 scans, and the ATE (SE(3)-aligned,
the port's ``eval/metrics.py``) over the first 500, 770 and ``n`` scans.
"""

import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from icpslam_tpu_torch.config import kitti_config  # noqa: E402
from icpslam_tpu_torch.eval import metrics  # noqa: E402
from icpslam_tpu_torch.geometry.se3 import Pose  # noqa: E402
from icpslam_tpu_torch.io import runner  # noqa: E402

REDUCED = dict(voxel_leaf_size=0.6, map_resolution=0.6, max_points=4096,
               max_raw_points=65536, max_map_points=65536)


def run(which: str, n: int):
    tcfg = kitti_config(**REDUCED)
    stream, gt = runner.kitti_proxy_source(tcfg, n, 10.0)
    if which == "jax":
        import jax

        from icpslam_tpu.cloud import pointcloud as jpc
        from icpslam_tpu.config import kitti_config as jax_kitti_config
        from icpslam_tpu.geometry import se3 as jse3
        from icpslam_tpu.pipeline import slam as jslam

        cfg = jax_kitti_config(**REDUCED)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
        step = jax.jit(jslam.slam_step, static_argnums=(2,))
        st = jslam.init_state(cfg, initial_pose=jse3.Pose(t=gt[0][0], q=gt[1][0]))
        recs = []
        for (pts, mask), stamp in stream:
            st, out = step(st, jpc.PointCloud(points=pts, mask=mask), cfg, stamp)
            recs.append(np.asarray(out.packed))
        rec = np.stack(recs)
        counts = dict(kf=int(st.keyframes.count), lc=int(st.num_loop_closures),
                      edges=int(st.edges.count))
    else:
        init = Pose(t=torch.from_numpy(gt[0][0]), q=torch.from_numpy(gt[1][0]))
        res = runner.run_slam(stream, tcfg, init, "cpu")
        rec = res.records
        counts = dict(kf=int(res.state.keyframes.count), lc=int(res.state.num_loop_closures),
                      edges=int(res.state.edges.count))
    return rec, gt, counts


def main(argv) -> int:
    which, n = argv[0], int(argv[1])
    t0 = time.time()
    rec, gt, counts = run(which, n)
    err = np.linalg.norm(rec[:, :3] - gt[0][:n], axis=-1)
    print(which, "%.0fs" % (time.time() - t0), counts, "rms %.4f" % np.sqrt((err ** 2).mean()))
    print(" ".join("%.3f" % e for e in err[::25]))
    for m in (500, 770, n):
        ate, _ = metrics.ate(Pose(torch.from_numpy(rec[:m, :3]), torch.from_numpy(rec[:m, 3:7])),
                             Pose(torch.from_numpy(gt[0][:m]), torch.from_numpy(gt[1][:m])))
        print(f"ATE over the first {m} scans: {ate:.4f} m")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
