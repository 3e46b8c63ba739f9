"""The port's tools (``icpslam_tpu_torch/tools/``) and examples
(``icpslam_tpu_torch/examples/``) against the JAX package's.

- ``endurance`` and ``kitti_tree_run`` with the runner stubbed, next to
  JAX's tools loaded from their paths with the same stub: the runner argv
  lists are equal once the port's ``--device`` is stripped and the
  temporary paths normalised, and the artifacts are equal key for key
  (the derived ``end_gap_m``, ``tail_rmse_m`` and
  ``late_mission_scans_per_sec`` included) but for the port's ``card``
  and ``backend`` and the notes; the port's endurance refuses a scan cache
  shorter than ``--scans``;
- the probes' stream equals ``bench._make_stream``'s, and their variants
  equal JAX's configs field for field;
- ``sharded_endurance --device cpu --scans 24`` runs, with JAX's artifact
  keys and 8-long per-shard lists;
- the examples run on the CPU; ``synthetic_city``'s exports read back and
  its checkpoint loads in JAX's ``checkpoint.load``. The city runs at
  reduced capacities (the JAX example's fields otherwise): the plain
  versions of K1/K2 evaluate every padded row on the CPU;
- without a card, every tool exits with an error on ``--device cuda``.

No JAX drive runs here: JAX's tools are stubbed, its probes and sharded
drives are not run.
"""

import torch

# one intra-op thread per test worker: the suite runs several pytest
# workers on the host's cores beside XLA's own pool
torch.set_num_threads(1)

import dataclasses
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from icpslam_tpu import config as jax_config
from icpslam_tpu_torch.examples import sharded_streaming as t_stream
from icpslam_tpu_torch.examples import synthetic_city as t_city
from icpslam_tpu_torch.tools import endurance as t_end
from icpslam_tpu_torch.tools import kitti_tree_run as t_tree
from icpslam_tpu_torch.tools import probe_scan_to_map as t_s2m
from icpslam_tpu_torch.tools import probe_step_budget as t_budget
from icpslam_tpu_torch.tools import sharded_endurance as t_sharded
from icpslam_tpu_torch.tools import streams

REPO = Path(__file__).resolve().parent.parent


def _jax_tool(name):
    """A JAX tool loaded from its path (neither imports JAX at module level)."""
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _summary(n: int, k: int) -> dict:
    """A canned runner summary for an ``n``-scan run (``k`` varies it)."""
    return {"scans": n, "wall_time_s": 10.0 + k, "wall_scans_per_sec": n / (10.0 + k),
            "keyframes": 100 + 7 * k, "keyframe_evictions": 3 * k, "loop_closures": 11 + k,
            "optimizations": 5 + k, "compile_ms": 900.0 + 10 * k, "step_ms_p50": 20.0 + k,
            "ate_m": 0.1 + 0.01 * k, "deferred_launched": 4, "deferred_folded": 4,
            "loader": "native", "_invocation_wall_s": 12.5}


def _traj(n: int, offset: float) -> np.ndarray:
    return (np.arange(3 * n, dtype=np.float32).reshape(n, 3) * 0.1 + offset).astype(np.float32)


def _stub_runner(calls: list, half: int):
    """A ``run_runner`` stand-in: records the argv, writes a trajectory at
    ``--out`` (A: the whole mission; B2: its tail, shifted) and returns a
    canned summary."""
    def run(args, timeout=3000.0):
        args = list(args)
        calls.append(args)
        n = int(args[args.index("--poses") + 1])
        start = int(args[args.index("--start") + 1]) if "--start" in args else 0
        if "--out" in args:
            out = args[args.index("--out") + 1]
            t = _traj(n, 0.0)[start:] + (0.05 if start else 0.0)
            np.savez(out, t=t, q=np.tile([1, 0, 0, 0], (len(t), 1)).astype(np.float32))
        return _summary(n - start, len(calls))
    return run


def _norm_argv(args, tmp_prefix: str):
    out, skip = [], False
    for a in args:
        if skip:
            skip = False
            continue
        if a == "--device":
            skip = True
            continue
        out.append(re.sub(rf"^.*/{tmp_prefix}[^/]*/", "<tmp>/", a))
    return out


def _without(d: dict, keys) -> dict:
    return {k: v for k, v in d.items() if k not in keys}


def _equal_but_notes(a, b, path=""):
    """Equal key for key and value for value, texts under ``note`` aside."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            if k != "note":
                _equal_but_notes(a[k], b[k], f"{path}.{k}")
    else:
        assert a == b, (path, a, b)


def _cache(path, n: int, points: int = 64) -> None:
    rng = np.random.RandomState(0)
    q = rng.randn(n, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    np.savez(path, gt_t=rng.randn(n, 3).astype(np.float32), gt_q=q, tag=1,
             **{f"s{i}": rng.uniform(-20, 20, (points, 3)).astype(np.float32) for i in range(n)})


def test_endurance_matches_jax_tool(tmp_path, monkeypatch):
    scans = 8
    cache = tmp_path / "proxy.npz"
    _cache(cache, scans)
    jax_end = _jax_tool("endurance")
    jax_calls, port_calls = [], []
    # JAX's tool leaves its temporary directory behind: keep it in tmp_path
    mkdtemp = jax_end.tempfile.mkdtemp
    monkeypatch.setattr(jax_end.tempfile, "mkdtemp",
                        lambda suffix=None, prefix=None, dir=None: mkdtemp(suffix, prefix, tmp_path))
    monkeypatch.setattr(jax_end, "run_runner", _stub_runner(jax_calls, scans // 2))
    monkeypatch.setattr(sys, "argv", ["endurance.py", "--scans", str(scans), "--cache", str(cache),
                                      "--out", str(tmp_path / "jax.json")])
    assert jax_end.main() == 0
    monkeypatch.setattr(t_end, "run_runner", _stub_runner(port_calls, scans // 2))
    assert t_end.main(["--scans", str(scans), "--cache", str(cache), "--out",
                       str(tmp_path / "port.json"), "--device", "cpu"]) == 0

    assert len(port_calls) == len(jax_calls) == 6
    for p, j in zip(port_calls, jax_calls):
        assert p[p.index("--device") + 1] == "cpu"
        assert _norm_argv(p, "endurance_") == _norm_argv(j, "endurance_")
    jax_art = json.loads((tmp_path / "jax.json").read_text())
    port_art = json.loads((tmp_path / "port.json").read_text())
    assert port_art["card"] == {"device": "cpu"} and port_art["backend"].startswith("cpu")
    _equal_but_notes(_without(port_art, {"card", "backend"}), jax_art)
    eq = port_art["resume_equivalence"]
    assert eq["end_gap_m"] > 0 and eq["tail_rmse_m"] > 0
    assert port_art["late_mission_scans_per_sec"] > 0


def test_endurance_refuses_a_short_cache(tmp_path, monkeypatch):
    cache = tmp_path / "proxy.npz"
    _cache(cache, 4)
    calls = []
    monkeypatch.setattr(t_end, "run_runner", _stub_runner(calls, 4))
    with pytest.raises(SystemExit, match="holds 4 scans, fewer than --scans 8"):
        t_end.main(["--scans", "8", "--cache", str(cache), "--out", str(tmp_path / "e.json"),
                    "--device", "cpu"])
    assert not calls


def test_kitti_tree_run_matches_jax_tool(tmp_path, monkeypatch):
    n = 5
    cache = tmp_path / "proxy.npz"
    _cache(cache, n + 2)
    summary = {k: v for k, v in _summary(n, 1).items() if not k.startswith("deferred")}
    jax_tree = _jax_tool("kitti_tree_run")
    jax_calls, port_calls = [], []

    def fake_run(cmd, **kw):
        jax_calls.append(list(cmd))
        line = json.dumps(_without(summary, {"_invocation_wall_s"}))
        return subprocess.CompletedProcess(cmd, 0, stdout=f"ATE 0.1\n{line}\n", stderr="")

    monkeypatch.setattr(jax_tree.subprocess, "run", fake_run)
    monkeypatch.setattr(sys, "argv", ["kitti_tree_run.py", "--cache", str(cache), "--scans", str(n),
                                      "--root", str(tmp_path / "jax_tree"),
                                      "--out", str(tmp_path / "jax.json")])
    assert jax_tree.main() == 0
    monkeypatch.undo()

    def fake_runner(args, timeout=3000.0):
        port_calls.append(list(args))
        return dict(summary)

    monkeypatch.setattr(t_tree, "run_runner", fake_runner)
    assert t_tree.main(["--cache", str(cache), "--scans", str(n), "--root",
                        str(tmp_path / "port_tree"), "--out", str(tmp_path / "port.json"),
                        "--device", "cpu"]) == 0

    # the runner module and the interpreter aside, the same argv
    assert jax_calls[0][1:3] == ["-m", "icpslam_tpu.io.runner"]
    port_argv = [a.replace(str(tmp_path / "port_tree"), "<root>")
                 for a in _norm_argv(port_calls[0], "-")]
    jax_argv = [a.replace(str(tmp_path / "jax_tree"), "<root>") for a in jax_calls[0][3:]]
    assert port_argv == jax_argv
    # the two trees byte for byte
    files = sorted(p.relative_to(tmp_path / "jax_tree") for p in (tmp_path / "jax_tree").rglob("*")
                   if p.is_file())
    assert len(files) == n + 3
    for f in files:
        assert (tmp_path / "port_tree" / f).read_bytes() == (tmp_path / "jax_tree" / f).read_bytes()
    jax_art = json.loads((tmp_path / "jax.json").read_text())
    port_art = json.loads((tmp_path / "port.json").read_text())
    assert port_art["loader"] == jax_art["loader"] == "native"
    _equal_but_notes(_without(port_art, {"card", "backend", "tree_root"}),
                     _without(jax_art, {"tree_root"}))


def test_kitti_tree_run_refuses_the_python_reader(tmp_path, monkeypatch):
    cache = tmp_path / "proxy.npz"
    _cache(cache, 3)
    monkeypatch.setattr(t_tree, "run_runner",
                        lambda args, timeout=0: {**_summary(3, 0), "loader": "python"})
    with pytest.raises(RuntimeError, match="python reader"):
        t_tree.main(["--cache", str(cache), "--root", str(tmp_path / "t"), "--out",
                     str(tmp_path / "t.json"), "--device", "cpu"])


def test_probe_stream_equals_bench():
    import jax

    sys.path.insert(0, str(REPO))
    try:
        import bench
    finally:
        sys.path.remove(str(REPO))
    jcfg = jax_config.SlamConfig(voxel_leaf_size=0.2, max_points=8192, max_raw_points=32768)
    ref, rgt = bench._make_stream(jax, jcfg, 2, 0)
    got, gt = streams.make_stream(t_s2m.base_config(), 2, 0, "cpu")
    assert len(got) == len(ref) == 2
    for jc, tc in zip(ref, got):
        np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
        np.testing.assert_allclose(tc.points.numpy(), np.asarray(jc.points), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(gt[0], np.asarray(rgt.t))
    np.testing.assert_array_equal(gt[1], np.asarray(rgt.q))


def _jax_probe_variants():
    """JAX's probes' configs as their files build them
    (``tools/probe_scan_to_map.py:37-42, 79-90``, ``probe_step_budget.py:37-75``)."""
    JI, JS = jax_config.IcpConfig, jax_config.SlamConfig
    cfg = JS(voxel_leaf_size=0.2, icp_odometry=JI(mode="plane", max_iterations=10),
             max_points=8192, max_raw_points=32768)
    s2m = [("default_30iter", cfg)] + [
        (f"max_iter_{mi}", cfg.replace(
            icp_mapping=dataclasses.replace(cfg.icp_mapping, max_iterations=mi)))
        for mi in (15, 10, 6, 4)
    ] + [("eps_1e-3", cfg.replace(
        icp_mapping=dataclasses.replace(cfg.icp_mapping, transformation_epsilon=1e-3)))]
    budget = [
        ("full", cfg),
        ("no_loop_closure", cfg.replace(enable_loop_closure=False)),
        ("no_scan_to_map", cfg.replace(enable_scan_to_map=False)),
        ("no_eviction_branch", cfg.replace(keyframe_eviction="none")),
        ("odometry_point_mode", cfg.replace(
            icp_odometry=dataclasses.replace(cfg.icp_odometry, mode="point"),
            icp_mapping=dataclasses.replace(cfg.icp_mapping, mode="point"))),
        ("mapping_requery_1", cfg.replace(mapping_requery_rounds=1)),
        ("graph_noninc", cfg.replace(graph_incremental=False)),
    ]
    return {"scan_to_map": s2m, "step_budget": budget}


@pytest.mark.parametrize("probe", ["scan_to_map", "step_budget"])
def test_probe_variants_equal_jax(probe):
    port = {"scan_to_map": t_s2m, "step_budget": t_budget}[probe].variants()
    want = _jax_probe_variants()[probe]
    assert [t for t, _ in port] == [t for t, _ in want]
    for (tag, p), (_, j) in zip(port, want):
        assert dataclasses.asdict(p) == dataclasses.asdict(j), tag


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None for k, v in d.items()}


def _covers(got, want, path=""):
    for k, v in want.items():
        assert k in got, f"{path}.{k} missing"
        if isinstance(v, dict):
            _covers(got[k], v, f"{path}.{k}")


def test_sharded_endurance_runs(tmp_path, capsys):
    out = tmp_path / "sharded.json"
    assert t_sharded.main(["--device", "cpu", "--scans", "24", "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    jax_art = json.loads((REPO / "artifacts" / "sharded_endurance.json").read_text())
    _covers(_keys(art), _keys(jax_art))
    per = art["sharded"]["per_shard"]
    assert len(per["sizes"]) == len(per["overflow"]) == 8
    assert sum(per["sizes"]) == art["sharded"]["map_size"]
    assert art["sharded"]["poses_finite"] and art["single_device"]["poses_finite"]
    assert art["card"] == {"device": "cpu"}
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["sharded_endurance"] == "ok"


def test_synthetic_city_exports(tmp_path, monkeypatch, capsys):
    from icpslam_tpu.pipeline import slam as jslam
    from icpslam_tpu.utils import checkpoint as jcheckpoint

    small = dataclasses.replace(t_city.config(), max_points=2048, max_raw_points=2048,
                                max_map_points=8192)
    monkeypatch.setattr(t_city, "config", lambda: small)
    d = tmp_path / "city"
    assert t_city.main(["--cpu", "--poses", "12", "--scan-points", "2000", "--out-dir", str(d)]) == 0
    s = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert s["scans"] == 12 and s["card"] == {"device": "cpu"}
    assert len((d / "trajectory.txt").read_text().splitlines()) == 12
    assert len((d / "ground_truth.txt").read_text().splitlines()) == 12
    head = (d / "map.ply").read_bytes().split(b"end_header")[0].decode()
    assert int(head.split("element vertex ")[1].split()[0]) == s["map_points"] > 0
    graph = json.loads((d / "graph.json").read_text())
    assert len(graph["nodes"]) == s["keyframes"]
    assert "const DATA = {" in (d / "viewer.html").read_text()
    jcfg = jax_config.from_dict(dataclasses.asdict(small))
    state = jcheckpoint.load(str(d / "state.npz"), jslam.init_state(jcfg))
    assert int(state.keyframes.count) == s["keyframes"]


def test_sharded_streaming_runs(capsys):
    assert t_stream.main(["--device", "cpu", "--poses", "6", "--devices", "4"]) == 0
    r = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert r["devices"] == 4 and len(r["map_voxels_per_shard"]) == 4
    assert np.isfinite(r["ate_m"]) and sum(r["map_voxels_per_shard"]) == r["map_voxels_total"]
    peak = r["peak_map_voxels_per_shard"]
    assert len(peak) == 4 and 0 <= r["peak_map_step"] < 6
    assert r["peak_map_voxels_total"] > 0 and sum(peak) == r["peak_map_voxels_total"]


@pytest.mark.parametrize("name", ["endurance", "kitti_tree_run", "sharded_endurance",
                                  "probe_scan_to_map", "probe_step_budget", "sharded_streaming",
                                  "synthetic_city"])
def test_tools_refuse_cuda_without_a_card(name, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = {"endurance": t_end, "kitti_tree_run": t_tree, "sharded_endurance": t_sharded,
           "probe_scan_to_map": t_s2m, "probe_step_budget": t_budget,
           "sharded_streaming": t_stream, "synthetic_city": t_city}[name]
    monkeypatch.chdir(tmp_path)
    argv = [] if name == "synthetic_city" else ["--device", "cuda"]
    with pytest.raises(SystemExit, match="--device cpu" if argv else "--cpu"):
        mod.main(argv + (["--out", str(tmp_path / "x.json")] if name in (
            "endurance", "kitti_tree_run", "sharded_endurance") else []))
    assert not list(tmp_path.iterdir())
