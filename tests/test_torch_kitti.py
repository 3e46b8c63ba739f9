"""The port's KITTI path against the JAX package's: the tree writer, the
readers, the native loader it builds for itself, and the runner's
``--kitti`` drive.

One tree of 10 rendered urban scans (16,384 raw points each at most;
``tests/test_kitti_tree.py``'s world and drive), whose scan 5 is a small
cluster that the odometry rejects, is written once by each package's
``write_tree``. Its first 6 scans hold the files and readers to JAX's;
the runner test drives all 10 through both runners at 2,048 filtered
points with a 0.6 m voxel (the config of ``tests/test_kitti_tree.py``)
and holds every pose within 1e-3 m and the accepted, keyframe and
loop-closure counts equal.
"""

import torch

# one intra-op thread per test worker: the suite runs several pytest
# workers on the host's cores beside XLA's own pool
torch.set_num_threads(1)

import filecmp
import json
import os
from pathlib import Path

import numpy as np
import pytest

from icpslam_tpu import config as jconfig
from icpslam_tpu.geometry.se3 import Pose as JPose
from icpslam_tpu.io import kitti as jkitti
from icpslam_tpu.io import runner as jrunner
from icpslam_tpu_torch.io import kitti as tkitti
from icpslam_tpu_torch.io import native_loader as tnative
from icpslam_tpu_torch.io import runner as trunner
from icpslam_tpu_torch.io import synthetic as tsyn

N_SCANS = 10
N_FILES = 6
BAD_SCAN = 5
RAW = 16384
CFG = dict(max_points=2048, max_raw_points=RAW, max_map_points=65536, max_keyframes=64,
           max_edges=256, voxel_leaf_size=0.6, map_resolution=0.6)


def render_tree_inputs(n):
    """``n`` idealized scans along the small urban drive and its ground
    truth; scan ``BAD_SCAN`` is a small cluster 55 m away in the air, with
    nothing to register against, so the odometry rejects it."""
    world = tsyn.make_urban_world(seed=3, blocks=2, block_size=60.0, ground_density=1.5,
                                  wall_density=5.0, n_poles=80)
    gt = tsyn.make_urban_drive(n_poses=n, blocks=2, block_size=60.0, speed=8.0)
    scans = [tsyn.render_velodyne_scan(world, gt[0][i], gt[1][i], seed=3 + i,
                                       azimuth_bins=1024, max_points=RAW) for i in range(n)]
    if n > BAD_SCAN:
        scans[BAD_SCAN] = np.random.RandomState(7).uniform(0.0, 1.0, (500, 3)).astype(
            np.float32) + np.array([40.0, 30.0, 25.0], np.float32)
    return scans, gt


# the tree and both runners' drive of it, shared with
# tests/test_torch_runner_io.py when both files run in one process
_SHARED = {}


def shared_tree(tmp_path_factory):
    if "tree" not in _SHARED:
        scans, gt = render_tree_inputs(N_SCANS)
        root = str(tmp_path_factory.mktemp("port_tree"))
        tkitti.write_tree(root, "99", scans, gt)
        _SHARED["tree"] = {"port": root, "gt": gt, "scans": scans}
    return _SHARED["tree"]


def shared_drives(tmp_path_factory):
    """JAX's runner and the port's over the tree with ``--out``,
    ``--summary-out`` and ``--save-state``; the port's also with
    ``--debug-dump`` and ``--html`` refreshed every 3 scans. JAX's
    per-scan records are kept from its ``run_slam``."""
    if "drives" in _SHARED:
        return _SHARED["drives"]
    tree = shared_tree(tmp_path_factory)
    d = tmp_path_factory.mktemp("kitti_drive")
    cfg_yaml = str(d / "cfg.yaml")
    jconfig.save_yaml(jconfig.kitti_config(**CFG), cfg_yaml)
    common = ["--kitti", tree["port"], "--seq", "99", "--config", cfg_yaml, "--verbosity", "0"]
    jax_runs = []
    real = jrunner.run_slam

    def recording(*a, **kw):
        jax_runs.append(real(*a, **kw))
        return jax_runs[-1]

    jrunner.run_slam = recording
    try:
        assert jrunner.main([*common, "--cpu", "--out", str(d / "j.npz"),
                             "--summary-out", str(d / "j.json"),
                             "--save-state", str(d / "j_state.npz")]) == 0
    finally:
        jrunner.run_slam = real
    assert trunner.main([*common, "--device", "cpu", "--out", str(d / "t.npz"),
                         "--summary-out", str(d / "t.json"), "--save-state", str(d / "t_state.npz"),
                         "--debug-dump", str(d / "dump"), "--html", str(d / "view.html"),
                         "--html-every", "3"]) == 0
    _SHARED["drives"] = {"dir": d, "jax_per_scan": jax_runs[0].per_scan}
    return _SHARED["drives"]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    tree = shared_tree(tmp_path_factory)
    jax_ = str(tmp_path_factory.mktemp("jax_tree"))
    jkitti.write_tree(jax_, "99", tree["scans"], JPose(t=tree["gt"][0], q=tree["gt"][1]))
    return {**tree, "jax": jax_}


def _rel_files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*") if p.is_file())


def test_write_tree_files_equal_jax(trees):
    port, jax_ = trees["port"], trees["jax"]
    names = _rel_files(port)
    assert names == _rel_files(jax_)
    assert len([n for n in names if n.endswith(".bin")]) == N_SCANS
    for name in names:
        assert filecmp.cmp(os.path.join(port, name), os.path.join(jax_, name), shallow=False), name


def test_readers_equal_jax(trees):
    root = trees["port"]
    seq_dir = os.path.join(root, "sequences", "99")
    np.testing.assert_array_equal(tkitti.read_calib(seq_dir), jkitti.read_calib(seq_dir))
    np.testing.assert_array_equal(tkitti.read_poses(root, "99"), jkitti.read_poses(root, "99"))
    np.testing.assert_array_equal(tkitti.read_times(root, "99"), jkitti.read_times(root, "99"))
    files = tkitti.scan_files(root, "99")
    assert files == jkitti.scan_files(root, "99")
    for i, f in enumerate(files[:N_FILES]):
        for cap in (None, 3000):  # below and above capacity (the seeded subsample)
            np.testing.assert_array_equal(tkitti.read_scan(f, max_points=cap, seed=i),
                                          jkitti.read_scan(f, max_points=cap, seed=i))
    for stamps, n in ((np.array([0.0, 0.1]), 5), (np.zeros(0), 3), (np.arange(4.0), 2)):
        np.testing.assert_array_equal(tkitti._pad_stamps(stamps, n), jkitti._pad_stamps(stamps, n))


def test_ground_truth_velodyne_equals_jax(trees):
    t, q = tkitti.ground_truth_velodyne(trees["port"], "99")
    ref = jkitti.ground_truth_velodyne(trees["port"], "99")
    assert t.dtype == np.float32 and q.dtype == np.float32
    np.testing.assert_allclose(t, np.asarray(ref.t), rtol=0, atol=1e-6)
    np.testing.assert_allclose(q, np.asarray(ref.q), rtol=0, atol=1e-6)
    # and the round trip through Tr recovers the written trajectory
    np.testing.assert_allclose(t, trees["gt"][0], rtol=0, atol=1e-3)


def test_scan_stream_equals_jax(trees):
    root = trees["port"]
    got = list(tkitti.scan_stream(root, "99", capacity=RAW, max_points=3000, start=2,
                                  end=N_FILES, with_stamps=True))
    ref = list(jkitti.scan_stream(root, "99", capacity=RAW, max_points=3000, start=2,
                                  end=N_FILES, with_stamps=True))
    assert len(got) == len(ref) == N_FILES - 2
    for ((pts, mask), stamp), (cloud, jstamp) in zip(got, ref):
        np.testing.assert_array_equal(mask, np.asarray(cloud.mask))
        np.testing.assert_array_equal(pts, np.asarray(cloud.points))
        assert stamp == jstamp


def test_native_library_is_the_ports_own():
    lib = tnative.library_path()
    assert lib.parent == Path(tnative.__file__).resolve().parent.parent / "_build"
    assert tnative.available(), "g++ could not build native/scanio.cpp"
    assert lib.exists()


def test_native_reader_equals_python_reader_below_capacity(trees):
    files = tkitti.scan_files(trees["port"], "99")[:N_FILES]
    for f in files:
        pts, mask = tnative.read_scan(f, capacity=RAW)
        ref = jkitti.read_scan(f, max_points=RAW)
        assert int(mask.sum()) == ref.shape[0] and mask[: ref.shape[0]].all()
        np.testing.assert_array_equal(pts[mask], ref)
    # above capacity: an even stride of the in-range points, in file order
    pts, mask = tnative.read_scan(files[0], capacity=1000)
    full = jkitti.read_scan(files[0])
    assert mask.sum() == 1000
    rows = {tuple(p) for p in full}
    assert all(tuple(p) in rows for p in pts[mask])


def test_native_loader_in_order_and_raises_on_missing_file(trees, tmp_path):
    files = tkitti.scan_files(trees["port"], "99")[:N_FILES]
    order = files[::-1] + files
    got = list(tnative.PrefetchingLoader(order, capacity=RAW, threads=3, depth=2))
    assert len(got) == len(order)
    for (pts, mask), f in zip(got, order):
        np.testing.assert_array_equal(pts[mask], jkitti.read_scan(f, max_points=RAW))
    with pytest.raises(IOError):
        tnative.read_scan(str(tmp_path / "missing.bin"), capacity=64)
    with pytest.raises(IOError):
        list(tnative.PrefetchingLoader([files[0], str(tmp_path / "missing.bin")], capacity=RAW))
    # the stream over the tree yields the Python reader's stamps and points
    stream = list(tnative.scan_stream(trees["port"], "99", capacity=RAW, start=1, end=4,
                                      with_stamps=True))
    ref = list(jkitti.scan_stream(trees["port"], "99", capacity=RAW, start=1, end=4,
                                  with_stamps=True))
    for ((pts, mask), stamp), (cloud, jstamp) in zip(stream, ref):
        np.testing.assert_array_equal(pts[mask], np.asarray(cloud.points)[np.asarray(cloud.mask)])
        assert stamp == jstamp


@pytest.fixture(scope="module")
def runner_drives(tmp_path_factory):
    drives = shared_drives(tmp_path_factory)
    d = drives["dir"]
    out = {k: (dict(np.load(d / f"{k}.npz")), json.loads((d / f"{k}.json").read_text()))
           for k in ("j", "t")}
    out["jax_accepted"] = sum(r["accepted"] for r in drives["jax_per_scan"])
    return out


def test_runner_kitti_poses_equal_jax(runner_drives):
    (jt, js), (tt, ts) = runner_drives["j"], runner_drives["t"]
    assert ts["loader"] == "native"
    assert ts["scans"] == js["scans"] == N_SCANS
    dt = np.linalg.norm(tt["t"] - jt["t"], axis=-1)
    assert dt.max() <= 1e-3, dt
    np.testing.assert_array_equal(tt["gt_t"], jt["gt_t"])


def test_runner_kitti_counts_equal_jax(runner_drives):
    (_, js), (_, ts) = runner_drives["j"], runner_drives["t"]
    # the registered scans but the one scan of nothing
    assert ts["accepted"] == runner_drives["jax_accepted"] == N_SCANS - 2
    for key in ("keyframes", "loop_closures", "optimizations", "edges"):
        assert ts[key] == js[key], key
    assert ts["keyframes"] >= 3
    assert abs(ts["ate_m"] - js["ate_m"]) <= 1e-3
