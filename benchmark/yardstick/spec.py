"""Find a cell's parts by the names in ``BENCHMARK.json``.

- the configuration: the ``file`` its ``configs`` entry names (JSON:
  ``slam``, the ``SlamConfig`` fields; ``sensor``, the render; ``source``,
  ``reduced``, ``assumed``);
- the traffic: ``benchmark/traffic/<traffic>.json``;
- each metric: ``benchmark/metrics/<metric name>.py``, a module with
  ``read(ctx)`` that returns a number or None (nothing to read).

A cell reports the end-to-end metrics (``--trace 0``) or the per-layer
metrics (``--trace 1``) that list it under ``workloads``, or that have no
such list. Adding a configuration, a traffic mix or a metric takes new
files and entries only.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    entry: dict
    read: Callable


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic file's contents
    metrics: List[Metric]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reader(name: str, bench_dir: str) -> Callable:
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, trace: bool, root: str = ROOT,
              bench_dir: Optional[str] = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files and the
    metrics it reports in a ``--trace`` run (``trace``) or not."""
    bench_dir = bench_dir or os.path.join(root, "benchmark")
    b = load_json(os.path.join(root, "BENCHMARK.json"))
    cells: Dict[str, dict] = {w["name"]: w for w in b["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in b["configs"]}
    cfg_entry = configs[w["config"]]
    config = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"))
    entries = b["per_layer"] if trace else b["end_to_end"]
    metrics = [Metric(e["name"], e["unit"], e, _reader(e["name"], bench_dir))
               for e in entries if _applies(e, name)]
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                metrics=metrics)
