"""The PyTorch port as a package: no JAX import, its own copy of the
config held to the JAX one, the numpy scan producers against the JAX ones,
kernel modules that import without a compiler, the options of every
slice initialising, and the runner's CLI."""

import torch

# one intra-op thread per test worker: the suite runs several pytest
# workers on the host's cores beside XLA's own pool
torch.set_num_threads(1)

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from icpslam_tpu import config as jax_config
from icpslam_tpu.io import synthetic as jsyn
from icpslam_tpu_torch import config as tconfig
from icpslam_tpu_torch.cloud import pointcloud as tpc
from icpslam_tpu_torch.graph import pose_graph as tpg
from icpslam_tpu_torch.io import runner as trunner
from icpslam_tpu_torch.io import synthetic as tsyn
from icpslam_tpu_torch.ops import cuda_build, nn as tnn, radius_stats as trs
from icpslam_tpu_torch.pipeline import odometry as todo
from icpslam_tpu_torch.pipeline import slam as tslam
from icpslam_tpu_torch.utils import interop

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "icpslam_tpu_torch"


def _port_modules():
    return sorted(
        "icpslam_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py")
        if p.name != "__init__.py" and "_build" not in p.parts
    )


def test_import_leaves_jax_out():
    mods = _port_modules()
    code = (
        "import importlib, sys\n"
        "import icpslam_tpu_torch\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'icpslam_tpu.')))\n"
        "assert not bad, bad\n"
        # nothing executed from the JAX package's files either, under any name
        f"jax_pkg = {str(REPO / 'icpslam_tpu')!r} + '/'\n"
        "files = sorted(getattr(m, '__file__', None) or '' for m in list(sys.modules.values()))\n"
        "bad = [f for f in files if f.startswith(jax_pkg)]\n"
        "assert not bad, bad\n"
        # importing builds and loads no native library
        "from icpslam_tpu_torch.io import native_loader\n"
        "assert native_loader.load.cache_info().currsize == 0\n"
        "print(len(sys.modules))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


JAX_PKG = REPO / "icpslam_tpu"
# JAX's public names the port does not carry, on purpose: the internals of
# JAX's voxel sort (the port's ``cloud/voxel.py::_packed_keys`` sort
# replaces them; the voxel parity tests hold it to JAX), two helpers
# that return JAX ``NamedSharding`` objects (the port has none,
# ``parallel/mesh.py``) and ``StageTimer``, which blocks on every stage
# (the port's spans in ``utils/profiling.py`` measure without a sync)
NOT_PORTED = {
    ("cloud/voxel.py", "lexsort_order"),
    ("cloud/voxel.py", "segment_starts"),
    ("parallel/mesh.py", "replicated"),
    ("parallel/sharded_map.py", "shard_placement"),
    ("utils/profiling.py", "StageTimer"),
}
# JAX modules the port does not carry: the stage roofline models, whose
# operations follow the kernels' pair counters (the benchmark's byte bound,
# ``benchmark/yardstick/roofline.py``, reads the port's K1 and K2)
NOT_PORTED_MODULES = {"utils/roofline.py"}


def _jax_public_names(path: Path):
    """Public top-level ``def`` and ``class`` names of a JAX module, read
    with ``ast`` (the module is not imported)."""
    import ast

    tree = ast.parse(path.read_text())
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def _jax_init_exports(path: Path):
    """``(module, name)`` of each name a JAX ``__init__.py`` imports from
    its own package, read with ``ast``."""
    import ast

    out = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.module.startswith("icpslam_tpu"):
            out += [(node.module, a.asname or a.name) for a in node.names]
    return out


def test_every_public_jax_name_has_its_counterpart():
    """Every public top-level function and class of every module of
    ``icpslam_tpu/`` (the Pallas kernels under ``ops/pallas/`` aside) has a
    counterpart of the same name in the port's module of the same path;
    the only exceptions are ``NOT_PORTED`` and the modules of
    ``NOT_PORTED_MODULES``."""
    import importlib

    modules = sorted(p for p in JAX_PKG.rglob("*.py")
                     if p.name != "__init__.py" and "pallas" not in p.relative_to(JAX_PKG).parts)
    assert len(modules) > 40
    missing, exempt = [], set()
    for path in modules:
        rel = path.relative_to(JAX_PKG).as_posix()
        if rel in NOT_PORTED_MODULES:
            assert not (PORT / rel).exists(), f"{rel} is ported: drop it from NOT_PORTED_MODULES"
            exempt.add(rel)
            continue
        port = importlib.import_module(
            "icpslam_tpu_torch." + rel[:-3].replace("/", "."))
        for name in _jax_public_names(path):
            if (rel, name) in NOT_PORTED:
                exempt.add((rel, name))
                assert not hasattr(port, name), f"{rel}:{name} is ported: drop it from NOT_PORTED"
            elif not hasattr(port, name):
                missing.append(f"{rel}:{name}")
    assert not missing, missing
    assert exempt == NOT_PORTED | NOT_PORTED_MODULES


def test_subpackages_export_what_jax_exports():
    """Each name a JAX ``__init__.py`` exports imports from the port's
    counterpart package, ``SlamConfig`` from the top level included."""
    import importlib

    inits = sorted(p for p in JAX_PKG.rglob("__init__.py")
                   if "pallas" not in p.relative_to(JAX_PKG).parts)
    checked = 0
    for init in inits:
        rel = init.parent.relative_to(JAX_PKG)
        pkg = ".".join(("icpslam_tpu_torch",) + rel.parts)
        port = importlib.import_module(pkg)
        for module, name in _jax_init_exports(init):
            if module.startswith("icpslam_tpu.") and module != "icpslam_tpu.config":
                # ``from icpslam_tpu.cloud.pointcloud import PointCloud``:
                # the name is also the port's submodule's
                sub = importlib.import_module(module.replace("icpslam_tpu", "icpslam_tpu_torch", 1))
                assert getattr(port, name) is getattr(sub, name), f"{pkg}.{name}"
            else:
                assert hasattr(port, name), f"{pkg}.{name}"
            checked += 1
    assert checked > 40
    import icpslam_tpu_torch

    assert icpslam_tpu_torch.SlamConfig is tconfig.SlamConfig


def test_scan_library_is_the_ports_own():
    """The port builds ``native/scanio.cpp`` into its own ``_build/`` and
    loads that library, never the JAX package's ``native/libscanio.so``."""
    code = (
        "from icpslam_tpu_torch.io import native_loader as n\n"
        "assert n.available()\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'native/libscanio.so' not in maps\n"
        "assert str(n.library_path()) in maps\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert trunner.__doc__ and "--kitti" in trunner.__doc__


def test_config_is_the_ports_own():
    assert Path(tconfig.__file__).resolve().parent == PORT
    assert "icpslam_tpu_torch._shared_config" not in sys.modules
    assert tconfig.SlamConfig.__module__ == "icpslam_tpu_torch.config"


@pytest.mark.parametrize("name", ["kitti.yaml", "default.yaml"])
def test_config_copy_reads_yaml_as_jax_does(name):
    path = REPO / "configs" / name
    assert dataclasses.asdict(tconfig.from_yaml(str(path))) == dataclasses.asdict(
        jax_config.from_yaml(str(path))
    )


def test_config_save_yaml_round_trip(tmp_path):
    radius = dict(covariance_mode="radius", covariance_radius=1.0, covariance_sigma=0.5)
    cfg = tconfig.kitti_config(icp_odometry=tconfig.IcpConfig(**radius), graph_window=32)
    tconfig.save_yaml(cfg, str(tmp_path / "c.yaml"))
    assert tconfig.from_yaml(str(tmp_path / "c.yaml")) == cfg
    assert dataclasses.asdict(jax_config.from_yaml(str(tmp_path / "c.yaml"))) == dataclasses.asdict(cfg)


def test_radius_mission_config_file():
    """The committed YAML of the radius mission is chip_smoke.py's
    ``radius_config()``, read alike by the port and by JAX."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    path = str(PORT / "configs" / "kitti_radius.yaml")
    want = chip_smoke.radius_config()
    assert tconfig.from_yaml(path) == want
    assert dataclasses.asdict(jax_config.from_yaml(path)) == dataclasses.asdict(want)


def test_runner_config_flag(tmp_path):
    radius = tconfig.IcpConfig(covariance_mode="radius", covariance_radius=0.5,
                               covariance_sigma=0.25, max_iterations=5)
    cfg = trunner.synthetic_config().replace(
        max_points=1024, icp_odometry=radius,
        icp_mapping=tconfig.IcpConfig(mode="point", max_iterations=5))
    tconfig.save_yaml(cfg, str(tmp_path / "c.yaml"))
    out = tmp_path / "summary.json"
    assert trunner.main(["--synthetic", "--poses", "2", "--device", "cpu",
                         "--config", str(tmp_path / "c.yaml"), "--summary-out", str(out)]) == 0
    summary = json.loads(out.read_text())
    assert summary["scans"] == 2 and summary["processed"] == 1


def test_config_is_the_shared_one():
    port_fields = [f.name for f in dataclasses.fields(tconfig.SlamConfig)]
    jax_fields = [f.name for f in dataclasses.fields(jax_config.SlamConfig)]
    assert port_fields == jax_fields
    assert dataclasses.asdict(tconfig.kitti_config()) == dataclasses.asdict(jax_config.kitti_config())
    assert dataclasses.asdict(tconfig.tiny_config()) == dataclasses.asdict(jax_config.tiny_config())
    assert [f.name for f in dataclasses.fields(tconfig.IcpConfig)] == [
        f.name for f in dataclasses.fields(jax_config.IcpConfig)
    ]


def test_precision_flags():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


class TestProducers:
    """The numpy producers give the JAX producers' arrays for the same seed
    (within 1e-6 m: both compute the render in float32, term for term)."""

    def test_room_world_and_loop(self):
        np.testing.assert_array_equal(tsyn.make_room_world(3, 5000), jsyn.make_room_world(3, 5000))
        g = jsyn.make_loop_trajectory(n_poses=9, radius=4.0, laps=1.1)
        t, q = tsyn.make_loop_trajectory(n_poses=9, radius=4.0, laps=1.1)
        np.testing.assert_array_equal(t, np.asarray(g.t))
        np.testing.assert_array_equal(q, np.asarray(g.q))

    def test_scan_stream(self):
        world = jsyn.make_room_world(0, 6000)
        g = jsyn.make_loop_trajectory(n_poses=5, radius=4.0)
        ref = list(jsyn.scan_stream(world, g, capacity=1024, max_range=12.0,
                                    n_points=900, noise=0.01, rate_hz=10.0))
        got = list(tsyn.scan_stream(world, tsyn.make_loop_trajectory(5, 4.0), capacity=1024,
                                    max_range=12.0, n_points=900, noise=0.01, rate_hz=10.0))
        for (jc, js), ((pts, mask), ts) in zip(ref, got):
            np.testing.assert_array_equal(mask, np.asarray(jc.mask))
            np.testing.assert_allclose(pts, np.asarray(jc.points), rtol=0, atol=1e-6)
            assert js == ts

    def test_urban_world_drive_and_velodyne(self):
        world = tsyn.make_urban_world(seed=0)
        np.testing.assert_array_equal(world, jsyn.make_urban_world(seed=0))
        g = jsyn.make_urban_drive(n_poses=40)
        t, q = tsyn.make_urban_drive(n_poses=40)
        np.testing.assert_array_equal(t, np.asarray(g.t))
        np.testing.assert_array_equal(q, np.asarray(g.q))
        short = jsyn.make_urban_drive(n_poses=2)
        ref = list(jsyn.velodyne_stream(
            world, short, capacity=16384, distortion=False, dynamic=None,
            noise_range_coeff=0.0, dropout=0.0,
        ))
        got = list(tsyn.velodyne_stream(world, tsyn.make_urban_drive(n_poses=2), capacity=16384))
        for (jc, js), ((pts, mask), ts) in zip(ref, got):
            np.testing.assert_array_equal(mask, np.asarray(jc.mask))
            np.testing.assert_allclose(pts, np.asarray(jc.points), rtol=0, atol=1e-6)
            assert js == ts


def test_kernel_modules_import_without_compiler():
    # importing builds nothing and loads no library; CPU tensors take the
    # plain versions without nvcc or triton
    assert cuda_build.load.cache_info().currsize == 0
    assert "triton" not in sys.modules
    q = torch.zeros((4, 3))
    res = tnn.nearest_neighbors(q, q + 1.0, torch.ones(4, dtype=torch.bool))
    assert torch.allclose(res.dist2, torch.full((4,), 3.0))
    assert cuda_build.load.cache_info().currsize == 0
    assert cuda_build.library_path().name.startswith("libicpslam_kernels_")


def test_cuda_wrappers_refuse_cpu_tensors():
    q = torch.zeros((4, 3))
    m = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError):
        tnn.nn1_cuda(q, q, m)
    with pytest.raises(ValueError):
        tnn.knn_cuda(q, q, m, 2)
    with pytest.raises(ValueError):
        tnn.knn(q, q, m, 17)
    with pytest.raises(ValueError):
        trs.radius_moments_cuda(q, q, m, 1.0)
    with pytest.raises(ValueError):
        tnn.nn1_matmul_cuda(q, q, m)
    with pytest.raises(TypeError):
        tnn.nearest_neighbors(q.double(), q.double(), m)


_NOW_IN_SLICE = {
    "sharded-map": dict(map_backend="sharded", map_shards=8),
    "dist-direct": dict(graph_linear_solver="dist-direct"),
    "wheel-edges": dict(enable_wheel_odom_edges=True),
    "pcg": dict(graph_linear_solver="pcg"),
    "schur": dict(graph_linear_solver="schur"),
    "deferred": dict(defer_optimization=True),
    "deskew": dict(deskew_rounds=1),
    "deskew-joint": dict(deskew_rounds=1, deskew_mode="joint"),
    "deskew-alternate": dict(deskew_rounds=2, deskew_mode="alternate"),
    "voxel-map": dict(map_backend="voxel"),
    "collect-debug": dict(collect_debug=True),
}


@pytest.mark.parametrize("name", sorted(_NOW_IN_SLICE))
def test_now_in_slice_config_initialises(name):
    cfg = tconfig.tiny_config(**_NOW_IN_SLICE[name])
    state = tslam.init_state(cfg, device="cpu")
    assert int(state.keyframes.count) == 0 and int(state.edges.count) == 0
    if cfg.map_backend == "sharded":
        # no mesh needed, as in JAX: the map has all map_shards shards
        assert all(leaf.shape[0] == 8 for leaf in state.map)


@pytest.mark.parametrize("overrides", [dict(keyframe_eviction="drop"),
                                       dict(max_keyframes=9, keyframe_protect_recent=8)],
                         ids=["unknown-eviction", "store-below-protected-trail"])
def test_invalid_eviction_config_raises(overrides):
    with pytest.raises(ValueError, match="keyframe_eviction"):
        tslam.init_state(tconfig.tiny_config(**overrides), device="cpu")


def _room_scans(cfg, n):
    world = tsyn.make_room_world(0, 8000)
    gt = tsyn.make_loop_trajectory(n_poses=n, radius=3.0, laps=0.5)
    return [
        tpc.PointCloud(torch.from_numpy(p), torch.from_numpy(m))
        for p, m in tsyn.scan_stream(world, gt, capacity=cfg.max_raw_points,
                                     max_range=12.0, n_points=600)
    ]


def test_full_keyframe_store_marginalizes():
    cfg = tconfig.tiny_config(max_keyframes=2, keyframe_distance=0.1, max_points=512,
                              enable_loop_closure=False, keyframe_protect_recent=0)
    state = tslam.init_state(cfg, device="cpu")
    for scan in _room_scans(cfg, 4):
        state, _ = tslam.slam_step(state, scan, cfg)
    assert int(state.keyframes.evictions) >= 1
    assert int(state.keyframes.count) == 2
    n = int(state.edges.count)
    assert n >= 1 and bool(state.edges.valid[:n].all()) and not bool(state.edges.valid[n:].any())


@pytest.mark.parametrize("stage", ["icp_odometry", "icp_mapping"])
def test_radius_config_initialises(stage):
    radius = tconfig.IcpConfig(covariance_mode="radius", covariance_radius=0.6)
    cfg = tconfig.tiny_config(**{stage: radius})
    state = tslam.init_state(cfg, device="cpu")
    assert int(state.keyframes.count) == 0


def test_incremental_window_solve_runs():
    cfg = tconfig.tiny_config(graph_window=2, keyframes_window=3, keyframe_distance=0.1,
                              max_points=512, enable_loop_closure=False)
    state = tslam.init_state(cfg, device="cpu")
    calls = tpg.optimize_window.calls
    for scan in _room_scans(cfg, 4):
        state, out = tslam.slam_step(state, scan, cfg)
    # the solve at the 3rd keyframe finds more keyframes than the window
    # and no loop closure since the last solve
    assert int(state.num_optimizations) >= 1
    assert tpg.optimize_window.calls - calls == int(state.num_optimizations)
    assert torch.isfinite(state.keyframes.pose_graph.t).all()


def test_bucket_resolving_to_pcg_runs():
    edges = tpg.empty_edges(2048)
    nodes = tpg.se3.identity((512,))
    calls = tpg.optimize.pcg_solves
    opt, _ = tpg.optimize_bucketed(
        nodes, edges, torch.ones(512, dtype=torch.bool), 300, 299, linear_solver="auto"
    )
    assert tpg.optimize.pcg_solves == calls + 1
    assert torch.isfinite(opt.t).all() and torch.isfinite(opt.q).all()
    assert tpg.bucket_size(30, 40, 512, 2048, 64) == 64
    assert tpg.bucket_size(30, 300, 512, 2048, 64) == 128


@pytest.mark.parametrize(
    "entry", ["slam.init_state", "odometry.init_state", "interop.state_from_numpy", "runner CLI"]
)
def test_entry_points_default_to_the_card(entry):
    """Without a named device the port's entry points take the CUDA card,
    and on a machine without one they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    cfg = tconfig.tiny_config()
    if entry == "runner CLI":
        with pytest.raises(SystemExit, match="--device cpu"):
            trunner.main(["--synthetic", "--poses", "2"])
        return
    calls = {
        "slam.init_state": lambda: tslam.init_state(cfg),
        "odometry.init_state": lambda: todo.init_state(cfg),
        "interop.state_from_numpy": lambda: interop.state_from_numpy(
            interop.state_to_numpy(tslam.init_state(cfg, device="cpu"))
        ),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_runner_physics_proxy_raises():
    """The physics proxy runs now: without a named device it exits with the
    card error, like every entry point, and ``--deskew`` without the
    physics render exits as in JAX."""
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            trunner.main(["--kitti-proxy", "--poses", "2"])
    with pytest.raises(SystemExit, match="--deskew"):
        trunner.main(["--kitti-proxy", "--no-proxy-physics", "--deskew", "--poses", "2",
                      "--device", "cpu"])


_SMALL = ["--device", "cpu", "--max-raw-points", "8192", "--max-points", "1024",
          "--voxel", "0.8", "--map-resolution", "0.8"]


def test_runner_physics_default_is_coupled_free_twist(tmp_path, capsys):
    out = tmp_path / "s.json"
    assert trunner.main(["--kitti-proxy", "--poses", "3", *_SMALL, "--summary-out", str(out)]) == 0
    summary = json.loads(out.read_text())
    assert (summary["deskew_rounds"], summary["deskew_mode"], summary["deskew_free_twist"]) == (
        1, "coupled", True)
    assert summary["scans"] == 3 and summary["accepted"] == 2
    assert "no-INS de-skew on by default" in capsys.readouterr().err
    # a de-skew flag keeps the default off
    assert trunner.main(["--kitti-proxy", "--poses", "2", "--deskew", *_SMALL,
                         "--summary-out", str(out)]) == 0
    assert json.loads(out.read_text())["deskew_rounds"] == 0


def test_runner_scan_cache(tmp_path, capsys):
    cache, out = tmp_path / "scans.npz", tmp_path / "s.json"
    args = ["--kitti-proxy", "--poses", "3", *_SMALL, "--scan-cache", str(cache),
            "--summary-out", str(out)]
    assert trunner.main(args) == 0
    first = json.loads(out.read_text())
    assert int(np.load(cache)["tag"]) == 1 and np.load(cache)["s2"].shape[1] == 3
    assert trunner.main(args) == 0  # from the cache
    assert "re-rendering" not in capsys.readouterr().err
    again = json.loads(out.read_text())
    assert again["ate_m"] == first["ate_m"] and again["map_size"] == first["map_size"]
    # rendered with other physics flags: re-rendered and rewritten
    assert trunner.main([*args, "--no-proxy-physics"]) == 0
    assert "re-rendering" in capsys.readouterr().err
    assert int(np.load(cache)["tag"]) == 0
    want = [p[m] for (p, m), _ in trunner.kitti_proxy_source(
        tconfig.kitti_config(max_raw_points=8192), 3, 10.0)[0]]
    for i, w in enumerate(want):
        np.testing.assert_array_equal(np.load(cache)[f"s{i}"], w)


@pytest.mark.parametrize("tool", ["endurance", "kitti_tree_run", "sharded_endurance",
                                  "scaling_dcn", "elastic_dcn"])
def test_tool_defaults_write_no_file_that_predates_the_port(tool):
    """A tool's default ``--out`` (and ``--cache``) lies outside the JAX
    package's ``artifacts/`` and every other path of the repo but the
    port's own ``icpslam_tpu_torch/artifacts/``."""
    import importlib

    ap = importlib.import_module(f"icpslam_tpu_torch.tools.{tool}")._parser()
    out = Path(ap.get_default("out")).resolve()
    assert out.parent == PORT / "artifacts", out
    assert not out.is_relative_to(REPO / "artifacts")
    cache = ap.get_default("cache")
    if cache is not None:
        assert not Path(cache).resolve().is_relative_to(REPO), cache


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_refuses_without_a_card(tmp_path, alone):
    """``chip_smoke.py`` exits non-zero and prints no result where
    ``torch.cuda.is_available()`` is false, in the checkout and alone in a
    directory that holds nothing else of the repo."""
    script = REPO / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_bytes(script.read_bytes())
        script = tmp_path / "chip_smoke.py"
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_stops_every_process_it_starts():
    """``chip_smoke.py``'s exit path: multiprocessing's resource tracker is
    closed (not killed), and a child still running and the orphan of a
    child, adopted because the script is its descendants' subreaper, are
    killed and waited for: none is left."""
    code = """
import json, os, subprocess
import chip_smoke

if __name__ == "__main__":
    chip_smoke._adopt_orphans()
    import multiprocessing
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        pool.map(abs, range(2))
    child = subprocess.Popen(["sleep", "60"], stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
    orphan = int(subprocess.run(["sh", "-c", "sleep 60 >/dev/null 2>&1 & echo $!"],
                                capture_output=True, text=True).stdout)
    killed = chip_smoke._stop_children()
    print(json.dumps({"killed": sorted(killed), "want": sorted([child.pid, orphan]),
                      "left": sorted(chip_smoke._descendants(os.getpid()))}))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.splitlines()[-1])
    assert out["killed"] == out["want"] and out["left"] == []


def test_chip_smoke_stops_its_processes_when_terminated():
    """SIGTERM, the signal a time limit sends, ends ``chip_smoke.py`` through
    the same exit path: the child it had running is killed and waited for."""
    code = """
import subprocess, sys, time
import chip_smoke

def main(argv=None):
    child = subprocess.Popen(["sleep", "60"], stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
    print(child.pid, flush=True)
    time.sleep(60)

chip_smoke.main = main
sys.exit(chip_smoke._run())
"""
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        child = int(proc.stdout.readline())
        proc.terminate()
        _, err = proc.communicate(timeout=30)
    finally:
        proc.kill()
    assert proc.returncode == 143, err
    assert not os.path.exists(f"/proc/{child}")
