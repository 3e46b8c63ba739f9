"""What a run of the port leaves behind, against the JAX package's: the
runner's ``--out`` and summary, checkpoints in both directions, resume,
``--debug-dump``, ``--chunk``, the scan prefetch and the live directory
stream.

The runner cases read the products of ``tests/test_torch_kitti.py``'s
drive of its 10-scan KITTI tree by both runners (shared when both files
run in one process), whose scan 5 the odometry rejects. The resume and
chunk cases run the room loop at a small config.
"""

import torch

# one intra-op thread per test worker: the suite runs several pytest
# workers on the host's cores beside XLA's own pool
torch.set_num_threads(1)

import json
import os
import re
import threading
import time

import jax
import numpy as np
import pytest

from icpslam_tpu import config as jconfig
from icpslam_tpu.io import live as jlive
from icpslam_tpu.io import runner as jrunner
from icpslam_tpu.pipeline import slam as jslam
from icpslam_tpu.utils import checkpoint as jckpt
from icpslam_tpu_torch import config as tconfig
from icpslam_tpu_torch.cloud import pointcloud as tpc
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.io import live as tlive
from icpslam_tpu_torch.io import prefetch as tprefetch
from icpslam_tpu_torch.io import runner as trunner
from icpslam_tpu_torch.io import synthetic as tsyn
from icpslam_tpu_torch.pipeline import slam as tslam
from icpslam_tpu_torch.utils import checkpoint as tckpt
from icpslam_tpu_torch.utils import interop

from test_torch_kitti import BAD_SCAN, CFG, N_SCANS, render_tree_inputs, shared_drives



@pytest.fixture(scope="module")
def drives(tmp_path_factory):
    return {**shared_drives(tmp_path_factory),
            "cfg": (jconfig.kitti_config(**CFG), tconfig.kitti_config(**CFG))}


def test_out_has_jax_keys(drives):
    d = drives["dir"]
    j, t = np.load(d / "j.npz"), np.load(d / "t.npz")
    assert sorted(t.files) == sorted(j.files) == ["gt_q", "gt_t", "q", "t"]
    for k in j.files:
        assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
    np.testing.assert_array_equal(t["gt_t"], j["gt_t"])
    assert np.linalg.norm(t["t"] - j["t"], axis=-1).max() <= 1e-3


def test_summary_carries_every_jax_key(drives):
    d = drives["dir"]
    js, ts = json.loads((d / "j.json").read_text()), json.loads((d / "t.json").read_text())
    assert set(js) <= set(ts), sorted(set(js) - set(ts))
    assert set(js["wall_vs_step"]) - {"compile_s"} <= set(ts["wall_vs_step"])
    for key in ("scans", "keyframes", "keyframe_evictions", "edges", "edge_overflow",
                "loop_closures", "optimizations", "map_size", "map_overflow", "poses", "workload"):
        assert ts[key] == js[key], key
    assert ts["stamp_origin"] == js["stamp_origin"]
    assert ts["loader"] == "native" and ts["processed"] == N_SCANS - 1
    assert ts["accepted"] == sum(r["accepted"] for r in drives["jax_per_scan"]) < N_SCANS


def _jax_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_checkpoint_keys_are_jax_keystr(drives):
    jcfg, tcfg = drives["cfg"]
    jkeys = list(_jax_leaves(jslam.init_state(jcfg)))
    tkeys = [k for k, _ in tckpt.leaves_with_paths(tslam.init_state(tcfg, device="cpu"))]
    assert tkeys == jkeys
    assert ".keyframes.pose_graph.t" in tkeys


def test_port_checkpoint_loads_into_jax(drives):
    d = drives["dir"]
    jcfg, tcfg = drives["cfg"]
    loaded = _jax_leaves(jckpt.load(str(d / "t_state.npz"), jslam.init_state(jcfg)))
    port = tckpt.load(str(d / "t_state.npz"), tslam.init_state(tcfg, device="cpu"))
    saved = np.load(d / "t_state.npz")
    assert sorted(saved.files) == sorted(loaded)
    for key, value in tckpt.leaves_with_paths(port):
        np.testing.assert_array_equal(loaded[key], value.numpy(), err_msg=key)
        np.testing.assert_array_equal(saved[key], value.numpy(), err_msg=key)
    assert int(port.keyframes.count) >= 2


def test_jax_checkpoint_loads_into_the_port(drives):
    d = drives["dir"]
    jcfg, tcfg = drives["cfg"]
    state = tckpt.load(str(d / "j_state.npz"), tslam.init_state(tcfg, device="cpu"))
    ref = _jax_leaves(jckpt.load(str(d / "j_state.npz"), jslam.init_state(jcfg)))
    for key, value in tckpt.leaves_with_paths(state):
        assert value.numpy().dtype == ref[key].dtype, key
        np.testing.assert_array_equal(value.numpy(), ref[key], err_msg=key)
    # the loaded state steps on in the port
    scan = tpc.empty(tcfg.max_raw_points)
    tslam.slam_step(state, scan, tcfg)


def test_missing_leaf_warns_in_both(drives, tmp_path):
    d = drives["dir"]
    jcfg, tcfg = drives["cfg"]
    data = dict(np.load(d / "t_state.npz"))
    del data[".keyframes.evictions"]
    path = str(tmp_path / "old.npz")
    np.savez(path, **data)
    template = tslam.init_state(tcfg, device="cpu")
    with pytest.warns(UserWarning, match="predates state leaf .keyframes.evictions"):
        state = tckpt.load(path, template)
    assert int(state.keyframes.evictions) == 0
    assert int(state.keyframes.count) == int(data[".keyframes.count"])
    with pytest.warns(UserWarning, match="predates state leaf .keyframes.evictions"):
        jckpt.load(path, jslam.init_state(jcfg))
    data[".keyframes.pose_graph.t"] = data[".keyframes.pose_graph.t"][:3]
    np.savez(path, **data)
    with pytest.raises(ValueError, match="shape"):
        tckpt.load(path, template)


def test_debug_dump_names_and_keys_are_jax(drives, tmp_path):
    """The port dumps exactly the scans JAX's rule picks from JAX's own
    records, under JAX's names, with the keys JAX's writer gives the same
    output."""
    d = drives["dir"]
    want, prev = [], None
    for i, r in enumerate(drives["jax_per_scan"]):  # JAX runner.py:379-400
        if i > 0 and not r["accepted"]:
            want.append(f"scan_{i:06d}_odometry_reject.npz")
        elif (r["accepted"] and not r["refined"] and r["num_keyframes"] > 1
              and (prev is None or prev > 0)):
            want.append(f"scan_{i:06d}_refine_fail.npz")
        prev = r["map_size"]
    got = sorted(os.listdir(d / "dump"))
    assert got == want and f"scan_{BAD_SCAN:06d}_odometry_reject.npz" in got
    # JAX's writer on a port output with the debug products
    _, tcfg = drives["cfg"]
    cfg = tcfg.replace(collect_debug=True)
    state = tslam.init_state(cfg, device="cpu")
    scans, _ = render_tree_inputs(3)  # the third scan is the first one refined on a map
    for pts in scans:
        state, out = tslam.slam_step(state, tpc.PointCloud(*map(torch.from_numpy,
                                                                  tsyn.pad(pts, cfg.max_raw_points))), cfg)
    assert out.debug is not None and bool(out.debug.nn_mask.any())
    jrunner._dump_debug_scan(str(tmp_path), 2, interop.state_to_numpy(out), "refine_fail")
    trunner._dump_debug_scan(str(tmp_path / "port"), 2, out, "refine_fail")
    ref = np.load(tmp_path / "scan_000002_refine_fail.npz")
    mine = np.load(tmp_path / "port" / "scan_000002_refine_fail.npz")
    assert sorted(mine.files) == sorted(ref.files)
    for k in ref.files:
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)
    dumped = np.load(d / "dump" / f"scan_{BAD_SCAN:06d}_odometry_reject.npz")
    assert sorted(dumped.files) == sorted(ref.files) and str(dumped["reason"]) == "odometry_reject"


def test_html_viewer_written_during_and_after_the_run(drives):
    text = (drives["dir"] / "view.html").read_text()
    data = json.loads(re.search(r"const DATA = (.*?);\n", text).group(1))
    assert data["stats"]["keyframes"] >= 2
    assert {"trajectory", "ground truth", "graph nodes"} <= {ly["name"] for ly in data["layers"]}


@pytest.mark.parametrize("flags", [
    [],
    ["--voxel", "0.3", "--max-keyframes", "16", "--icp-mode", "point", "--extrinsic", "0.1,0,0.5"],
    ["--skip", "2", "--window", "6", "--keyframe-distance", "0.5", "--verbosity", "0",
     "--max-map-points", "4096", "--max-points", "1024", "--max-raw-points", "2048",
     "--map-resolution", "0.25", "--extrinsic", "0,0,1,0.9,0,0,0.1"],
], ids=["defaults", "sizes-mode-extrinsic", "cadence-sizes"])
def test_config_flags_build_jax_config(flags):
    """The config each source gets from the flags is the one JAX's runner
    builds from them (``_build_config`` for ``--synthetic``,
    ``kitti_config`` with the explicit overrides for the KITTI sources)."""
    import dataclasses

    args = trunner._parser().parse_args(["--synthetic", *flags])
    assert dataclasses.asdict(trunner.build_config(args)) == dataclasses.asdict(
        jrunner._build_config(args))
    args = trunner._parser().parse_args(["--kitti", "ROOT", *flags])
    kw = jrunner._explicit_overrides(None, args)
    if "max_keyframes" in kw:
        kw.setdefault("max_edges", kw["max_keyframes"] * 4)
    want = jrunner._apply_icp_mode(jconfig.kitti_config(**kw), None, args)
    assert dataclasses.asdict(trunner.build_config(args)) == dataclasses.asdict(want)


# ---- resume and chunks on the room loop -------------------------------------

SMALL = ["--synthetic", "--voxel", "0.3", "--map-resolution", "0.3", "--max-points", "512",
         "--max-raw-points", "4096", "--max-map-points", "4096", "--max-keyframes", "16",
         "--keyframe-distance", "0.5", "--verbosity", "0", "--device", "cpu"]


def _resume_cfg():
    return tconfig.tiny_config(
        voxel_leaf_size=0.3, map_resolution=0.3,
        icp_odometry=tconfig.IcpConfig(mode="point", max_iterations=10),
        icp_mapping=tconfig.IcpConfig(mode="point", max_iterations=10),
        max_points=512, max_raw_points=2048, max_map_points=4096, max_keyframes=32, max_edges=64,
    )


def test_resumed_work_matches_full_run(tmp_path):
    """JAX's ``test_resumed_work_matches_full_run`` criterion on the port:
    from a checkpoint at scan 6 (load and map re-render), the tail does
    the uninterrupted run's work: the same keyframe and optimize cadence,
    ICP iterations within 1 on average."""
    cfg = _resume_cfg()
    world = tsyn.make_room_world(seed=0, n_points=8000)
    gt = tsyn.make_loop_trajectory(n_poses=12, radius=5.0, laps=0.4)
    scans = [tpc.PointCloud(torch.from_numpy(p), torch.from_numpy(m))
             for p, m in tsyn.scan_stream(world, gt, capacity=2048, n_points=800, seed=0)]
    init = Pose(torch.from_numpy(gt[0][0]), torch.from_numpy(gt[1][0]))

    def work(out):
        return (int(out.odom_out.iterations), bool(out.new_keyframe), bool(out.optimized))

    state, tail_full = tslam.init_state(cfg, init, device="cpu"), []
    for i, scan in enumerate(scans):
        state, out = tslam.slam_step(state, scan, cfg)
        if i == 5:
            path = str(tmp_path / "ckpt.npz")
            tckpt.save(path, state)
        if i >= 6:
            tail_full.append(work(out))
    restored = tckpt.load(path, tslam.init_state(cfg, device="cpu"))
    restored = tckpt.rerender_map(restored, cfg)
    assert int(restored.map.size) > 0
    tail = []
    for scan in scans[6:]:
        restored, out = tslam.slam_step(restored, scan, cfg)
        tail.append(work(out))
    it_f = np.array([w[0] for w in tail_full], float)
    it_r = np.array([w[0] for w in tail], float)
    assert abs(it_f.mean() - it_r.mean()) <= 1.0, (it_f, it_r)
    assert [w[1] for w in tail_full] == [w[1] for w in tail]
    assert [w[2] for w in tail_full] == [w[2] for w in tail]


def test_cli_save_state_and_resume(tmp_path, capsys):
    ckpt = str(tmp_path / "state.npz")
    assert trunner.main([*SMALL, "--poses", "6", "--save-state", ckpt]) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert trunner.main([*SMALL, "--poses", "6", "--resume", ckpt]) == 0
    second = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert second["resumed_keyframes"] == first["keyframes"] >= 2
    assert second["resumed_map_size"] > 0
    assert second["keyframes"] >= first["keyframes"]


def test_chunk3_equals_chunk1(tmp_path, capsys):
    outs = {}
    for chunk in (1, 3):
        path = str(tmp_path / f"c{chunk}.npz")
        assert trunner.main([*SMALL, "--poses", "7", "--chunk", str(chunk), "--out", path]) == 0
        outs[chunk] = (np.load(path), json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    (a, sa), (b, sb) = outs[1], outs[3]
    np.testing.assert_array_equal(a["t"], b["t"])
    np.testing.assert_array_equal(a["q"], b["q"])
    for key in ("scans", "accepted", "processed", "keyframes", "edges", "loop_closures",
                "optimizations", "map_size"):
        assert sa[key] == sb[key], key
    assert sb["scans"] == 7 and sb["chunk"] == 3
    with pytest.raises(SystemExit, match="chunk 1"):
        trunner.main([*SMALL, "--poses", "4", "--chunk", "2", "--debug-dump", str(tmp_path)])


# ---- prefetch ----------------------------------------------------------------

def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "scan-prefetch" and t.is_alive()]


def test_prefetch_keeps_order_and_reraises():
    assert list(tprefetch.prefetch(range(20), lambda x: x * x, depth=3)) == [x * x for x in range(20)]
    assert list(tprefetch.prefetch(range(5), str, depth=0)) == ["0", "1", "2", "3", "4"]

    def failing():
        yield 1
        yield 2
        raise RuntimeError("producer failed")

    got = []
    with pytest.raises(RuntimeError, match="producer failed"):
        for x in tprefetch.prefetch(failing(), lambda x: x, depth=2):
            got.append(x)
    assert got == [1, 2]
    assert not _prefetch_threads()


def test_prefetch_worker_ends_when_the_consumer_leaves():
    closed = threading.Event()

    def endless():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.set()

    gen = tprefetch.prefetch(endless(), lambda x: x, depth=3)
    assert [next(gen) for _ in range(4)] == [0, 1, 2, 3]
    gen.close()  # the consumer leaves
    assert not _prefetch_threads()
    assert closed.is_set()  # the source was closed by the worker
    for x in tprefetch.prefetch(endless(), lambda x: x, depth=2):  # break out of a for
        if x == 5:
            break
    assert not _prefetch_threads()


def test_uploader_on_the_cpu_wraps_without_copy():
    up = tprefetch.Uploader("cpu")
    pts, mask = tsyn.pad(np.ones((5, 3), np.float32), 8)
    (tp, tm), event = up.upload((pts, mask))
    assert event is None and tp.data_ptr() == pts.ctypes.data
    assert up.ready((tp, tm), event)[1].sum() == 5


# ---- live directory ingest ----------------------------------------------------

def _write_scan(d, name, pts):
    tmp = os.path.join(d, name + ".tmp")
    np.c_[pts, np.zeros((pts.shape[0], 1), np.float32)].astype(np.float32).tofile(tmp)
    os.rename(tmp, os.path.join(d, name))


def _pts(seed, n=300):
    p = np.random.RandomState(seed).uniform(-20, 20, (n, 3)).astype(np.float32)
    r = np.linalg.norm(p, axis=-1)
    return p[(r > 3.0) & (r < 70.0)]


def _both(d, **kw):
    ref = [(np.asarray(c.points)[np.asarray(c.mask)], s)
           for c, s in jlive.directory_stream(d, capacity=1024, use_native=False, **kw)]
    mine = [((p[m]), s) for (p, m), s in tlive.directory_stream(d, capacity=1024, **kw)]
    return ref, mine


def _same(ref, mine):
    assert [s for _, s in mine] == [s for _, s in ref]
    for (a, _), (b, _) in zip(ref, mine):
        np.testing.assert_array_equal(a, b)


def test_live_arrival_order_equals_jax(tmp_path):
    d = str(tmp_path)
    # digit-count boundary: parsed-stamp order, not lexicographic
    for i, stamp in enumerate([99.8, 100.0, 99.9, 100.1]):
        _write_scan(d, f"{stamp:.1f}.bin", _pts(i))
    np.c_[_pts(9)[:5], np.zeros((5, 1))].astype(np.float32).tofile(os.path.join(d, "7.bin.tmp"))
    open(os.path.join(d, tlive.STOP_FILE), "w").close()
    ref, mine = _both(d, poll_interval=0.01)
    assert [s for _, s in mine] == [99.8, 99.9, 100.0, 100.1]
    _same(ref, mine)


def test_live_idle_timeout_equals_jax(tmp_path):
    d = str(tmp_path)
    _write_scan(d, "000000.bin", _pts(0))
    t0 = time.monotonic()
    ref, mine = _both(d, poll_interval=0.01, idle_timeout=0.2)
    assert len(mine) == 1 and 0.4 <= time.monotonic() - t0 < 5.0
    _same(ref, mine)


def test_live_watermark_equals_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jlive, "_SEEN_LIMIT", 4)
    monkeypatch.setattr(tlive, "_SEEN_LIMIT", 4)
    d = str(tmp_path)
    for i in range(10):
        _write_scan(d, f"{100.0 + 0.1 * i:.6f}.bin", _pts(i))
    open(os.path.join(d, tlive.STOP_FILE), "w").close()
    ref, mine = _both(d, poll_interval=0.01)
    assert len(mine) == 10 and len({s for _, s in mine}) == 10
    _same(ref, mine)
    # the Python reader gives the native reader's points below capacity
    py = [(p[m], s) for (p, m), s in tlive.directory_stream(d, capacity=1024, use_native=False,
                                                             poll_interval=0.01)]
    _same(py[:10], mine[:10])
