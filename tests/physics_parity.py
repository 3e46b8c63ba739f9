"""The KITTI-proxy drive with the sensor-physics render through the JAX
package and the port on the CPU, at the reduced widths of the runners'
CPU drives (16,384 raw and 2,048 filtered points, 0.6 m voxel and map
resolution), in three modes: the in-loop coupled de-skew with the freed
source twist (the runners' ``--kitti-proxy`` default), the same with the
constant-velocity tie (``chip_smoke.py`` phase 15) and the INS de-skew
at ingest (``--deskew``). ``--voxel`` runs the idealized render with the
voxel map instead (``map_backend='voxel'``, the drive of ``chip_smoke.py``
phase 16). Not collected by pytest: a run takes minutes.

    JAX_PLATFORMS=cpu python tests/physics_parity.py 60
    JAX_PLATFORMS=cpu python tests/physics_parity.py 40 --voxel

Both packages get the same scans (the port's numpy producers, equal to
JAX's: ``tests/test_torch_physics.py``) from the same initial pose. It
prints, per mode and package, the accepted scans, keyframes and the ATE
(SE(3)-aligned, the port's ``eval/metrics.py``).
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

REDUCED = dict(max_raw_points=16384, max_points=2048, voxel_leaf_size=0.6, map_resolution=0.6)
# name: (kitti_proxy_source options, config overrides)
MODES = {
    "coupled free-twist": (dict(physics=True), dict(deskew_rounds=1, deskew_free_twist=True)),
    "coupled cv-tied": (dict(physics=True), dict(deskew_rounds=1)),
    "INS de-skew": (dict(physics=True, deskew=True), {}),
}
VOXEL = {"voxel map": ({}, dict(map_backend="voxel"))}


def run_jax(scans, gt, overrides):
    import jax

    from icpslam_tpu.cloud import pointcloud as jpc
    from icpslam_tpu.config import kitti_config as jax_kitti_config
    from icpslam_tpu.geometry import se3 as jse3
    from icpslam_tpu.pipeline import slam as jslam

    cfg = jax_kitti_config(**REDUCED, **overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(kitti_config(**REDUCED, **overrides))
    step = jax.jit(jslam.slam_step, static_argnums=(2,))
    st = jslam.init_state(cfg, initial_pose=jse3.Pose(t=gt[0][0], q=gt[1][0]))
    recs = []
    for (pts, mask), stamp in scans:
        st, out = step(st, jpc.PointCloud(points=pts, mask=mask), cfg, stamp)
        recs.append(np.asarray(out.packed))
    return np.stack(recs), int(st.keyframes.count)


def run_port(scans, gt, overrides):
    cfg = kitti_config(**REDUCED, **overrides)
    init = Pose(t=torch.from_numpy(gt[0][0]), q=torch.from_numpy(gt[1][0]))
    res = runner.run_slam(scans, cfg, init, "cpu")
    return res.records, int(res.state.keyframes.count)


def main(argv) -> int:
    n = int(argv[0]) if argv else 60
    cfg = kitti_config(**REDUCED)
    for mode, (source, overrides) in (VOXEL if "--voxel" in argv else MODES).items():
        stream, gt = runner.kitti_proxy_source(cfg, n, 10.0, **source)
        scans = list(stream)
        for which, fn in (("jax", run_jax), ("port", run_port)):
            t0 = time.time()
            rec, kf = fn(scans, gt, overrides)
            ate, _ = metrics.ate(Pose(torch.from_numpy(rec[:, :3]), torch.from_numpy(rec[:, 3:7])),
                                 Pose(torch.from_numpy(gt[0]), torch.from_numpy(gt[1])))
            print(f"{mode:20s} {which:4s} {n} scans: ATE {ate:.4f} m, accepted "
                  f"{int(rec[:, 7].sum())}, keyframes {kf} ({time.time() - t0:.0f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
