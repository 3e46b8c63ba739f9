"""BENCHMARK.json against the contract's limits, and a configuration, a
traffic mix and a metric picked up by name with no edit to the harness."""

import json
import os
import re
import shutil

import pytest

from yardstick import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_to_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    cfgs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["source"]) and line_ok(c["why"])
        assert c["file"].startswith("benchmark/") and os.path.exists(
            os.path.join(spec.ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    cells = [w["name"] for w in b["workloads"]]
    assert len(set(cells)) == len(cells)
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line_ok(w["why"])
        assert w["config"] in cfgs and w["chips"] == 1
    assert set(cfgs) == {w["config"] for w in b["workloads"]}
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and line_ok(m["layer"]) and m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(spec.BENCH_DIR, "metrics", m["name"] + ".py"))
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("trace", [False, True])
def test_every_cell_loads_with_its_readers(trace):
    for w in bench()["workloads"]:
        cell = spec.load_cell(w["name"], trace=trace)
        assert cell.metrics and all(callable(m.read) for m in cell.metrics)
        assert cell.config["slam"]["max_raw_points"] == 131072
        assert int(cell.traffic["check_scans"]) <= int(cell.traffic["scans"])
    with pytest.raises(KeyError):
        spec.load_cell("no_such.cell", trace=False)


def test_new_files_and_entries_add_a_cell_and_a_metric(tmp_path):
    """A later change adds a configuration, a traffic mix and a per-layer
    metric as files and BENCHMARK.json entries; the harness finds them."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench()
    cfg = json.loads((root / "benchmark/configs/kitti_hdl64.json").read_text())
    cfg["slam"]["map_backend"] = "voxel"
    (root / "benchmark/configs/kitti_hdl64_voxel.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "benchmark/traffic/revisit.json").read_text())
    traffic["scans"] = 271
    (root / "benchmark/traffic/one_lap.json").write_text(json.dumps(traffic))
    # a reader of a program counter, counted by span in the profiled window
    (root / "benchmark/metrics/map_points_per_scan.py").write_text(
        "def read(ctx):\n"
        "    p = ctx.profiled\n"
        "    if p is None or p.program_counts is None or p.n == 0:\n"
        "        return None\n"
        "    by = p.program_counts.get('voxel_map.inserted', {})\n"
        "    return sum(by.get('scan_to_map.insert', [])[:p.n]) / p.n\n")
    b["configs"].append(dict(b["configs"][0], name="kitti_hdl64_voxel",
                             file="benchmark/configs/kitti_hdl64_voxel.json"))
    b["workloads"].append({"name": "kitti_hdl64_voxel.one_lap", "config": "kitti_hdl64_voxel",
                           "traffic": "one_lap", "chips": 1, "why": "the voxel map"})
    b["per_layer"].append({"name": "map_points_per_scan", "unit": "points", "better": "lower",
                           "source": "program_counter", "layer": "mapping/voxel_map.py",
                           "moves": "scans_per_s", "workloads": ["kitti_hdl64_voxel.one_lap"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.load_cell("kitti_hdl64_voxel.one_lap", trace=True, root=str(root))
    assert cell.config["slam"]["map_backend"] == "voxel" and cell.traffic["scans"] == 271
    assert [m.name for m in cell.metrics] == ["map_points_per_scan"]

    class Profiled:
        n = 3
        program_counts = {"voxel_map.inserted": {"total": [40.0, 44.0, 42.0, 9.0],
                                                 "scan_to_map.insert": [40.0, 44.0, 42.0, 9.0]}}

    class Ctx:
        profiled = Profiled()
    assert cell.metrics[0].read(Ctx()) == 42.0
    Ctx.profiled = None
    assert cell.metrics[0].read(Ctx()) is None
    e2e = spec.load_cell("kitti_hdl64_voxel.one_lap", trace=False, root=str(root))
    assert [m.name for m in e2e.metrics] == [m["name"] for m in b["end_to_end"]
                                             if "workloads" not in m]
    # the existing cells keep their metrics
    old = spec.load_cell("kitti_hdl64.revisit", trace=True, root=str(root))
    assert "map_points_per_scan" not in [m.name for m in old.metrics]
