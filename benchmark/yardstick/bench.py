"""A run from its set-up to its last line (``benchmark/run.py`` calls
:func:`run` once a card and the cell are found)."""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

from icpslam_tpu_torch.utils import profiling
from yardstick import compare, drive, imports, layers, reference
from yardstick.traffic import trajectory


def _card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def check(windows, scans, slam_dict: dict, init, rate_hz: float, n_check: int, device):
    """The reference over the sequence's first ``n_check`` scans against
    every replay of the windows: (correct, rows, scans compared, seconds)."""
    t0 = time.perf_counter()
    graphs = [g for w in windows for g in w.graphs]
    ref, ref_graphs = reference.replay(scans[:n_check], slam_dict, init[0], init[1], rate_hz,
                                       device, graph_at=sorted({g[0] for g in graphs}))
    nums, compared = compare.numbers([r for w in windows for r in w.replays], ref, graphs,
                                     ref_graphs)
    ok, rows = compare.verdict(nums, compared)
    return ok, rows, compared, time.perf_counter() - t0


def _log_window(w: drive.Window, ctx, scans: int) -> None:
    """Where a window's time went, for a reader of standard error."""
    n = ctx.n
    drive.log(f"window{' (traced)' if w.spans is not None else ''}: {n} scans in {w.seconds} s "
              f"over {len(w.replays)} replays")
    edges = w.start + np.arange(0.0, w.seconds + 1e-9, w.seconds / 6)
    per = np.histogram(np.asarray(w.completions[:n]), bins=edges)[0]
    step = np.asarray(w.step_s[:n]) * 1000.0
    records = np.concatenate(w.replays)[:n]
    index = np.concatenate([np.arange(len(r)) for r in w.replays])[:n]
    drive.log(f"window: scans per sixth {per.tolist()}; step ms median {np.median(step):.2f}, "
              f"mean {step.mean():.2f}, max {step.max():.2f} at scan {int(step.argmax())}; "
              f"solves {int(sum(w.optimized[:n]))} ({int(sum(w.window_solves[:n]))} window); "
              f"{100.0 * float(np.mean(index >= scans // 2)):.1f}% of the scans in a replay's "
              f"second half; map points max {int(records[:, 15].max())}")


def _log_layers(ctx) -> None:
    """The layers and the rest against the window's totals, per scan:
    launch calls, device ms (against busy), syncs (counted + implicit)."""
    got = layers.rollup(ctx)
    if got is None:
        return
    for what in ("launches", "device_ms", "syncs"):
        parts = " + ".join(f"{k} {v[what]!r}" for k, v in got.items() if k != "window")
        total = sum(v[what] for k, v in got.items() if k != "window")
        drive.log(f"layers: {what} a scan {parts} = {total!r}; the window's {got['window'][what]!r}")


def run(cell, args, render, t0: float) -> int:
    drive.log(f"set-up: torch and the program imported at {time.perf_counter() - t0:.2f} s")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.zeros(1, device=dev)
    drive.log(f"set-up: CUDA context at {time.perf_counter() - t0:.2f} s")
    slam_dict, sensor, traffic = cell.config["slam"], cell.config["sensor"], cell.traffic
    rate = float(sensor["rate_hz"])
    cfg = drive.config_of(cell.config)
    try:
        from icpslam_tpu_torch.ops import cuda_build

        t = time.perf_counter()
        cuda_build.load()
        drive.log(f"kernel library: {time.perf_counter() - t:.2f} s "
                  f"(build {cuda_build.load.build_seconds:.2f} s)")
        t = time.perf_counter()
    finally:
        scans = render.result()
    drive.log(f"render: {len(scans)} scans, {np.mean([len(s) for s in scans]):.0f} returns "
              f"a scan; waited {time.perf_counter() - t:.2f} s after the kernels")
    gt_t, gt_q = trajectory(traffic, sensor, args.seed)
    init = (gt_t[0], gt_q[0])
    before = profiling.snapshot()
    warm_s = drive.warm(cfg, scans, init, rate, dev)
    built = profiling.delta(before, profiling.snapshot())["counts"].get("graph.captures", 0)
    drive.log(f"warm-up: {warm_s:.2f} s, {built} graph captures (graph.captures), "
              f"done at {time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize(dev)
    n_check = int(traffic["check_scans"])
    window = drive.run_window(cfg, scans, init, rate, float(args.seconds), dev, traced=False,
                              snap_at=n_check)
    setup_s = window.start - t0
    windows = [window]
    if args.trace:
        # the host-clock readers keep the untraced window; the others read this one
        windows.append(drive.run_window(cfg, scans, init, rate, float(args.seconds), dev,
                                        traced=True, snap_at=n_check))
    peak = int(torch.cuda.max_memory_allocated(dev))
    ctx = drive.context(window, setup_s, profiled=windows[1] if args.trace else None)
    n = ctx.n
    metrics = {}
    for m in cell.metrics:
        value = m.read(ctx)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    for w, c in zip(windows, (ctx, ctx.profiled)):
        _log_window(w, c, int(traffic["scans"]))
    _log_layers(ctx.profiled)
    drive.log(f"setup {setup_s:.3f} s; peak {peak} bytes")
    gc.collect()
    torch.cuda.empty_cache()
    ok, rows, compared, ref_s = check(windows, scans, slam_dict, init, rate, n_check, dev)
    drive.log(f"reference: {compared} scans and {sum(len(w.graphs) for w in windows)} graphs "
              f"compared in {ref_s:.2f} s")
    found = imports.forbidden(sys.modules)
    if found:
        print(f"run.py: modules of JAX or the JAX package loaded: {found}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": cell.chips,
              "memory_peak_bytes": peak}
    # a window scan fails when its step gives no finite pose
    records = np.concatenate(window.replays)[:n]
    failed = int((~np.isfinite(records[:, :7])).any(axis=1).sum())
    result = {"correct": bool(ok), "attempted": n, "failed": failed,
              "metrics": metrics, "device": device}
    if ctx.profiled is not None:
        tr = ctx.profiled.trace
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": [[k, v] for k, v in tr.device_ops],
                               "idle_gaps": [[k, v] for k, v in tr.idle_gaps]}
        drive.log(f"card: {_card_line()}")
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    for name, v, lim in rows:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    print(f"check correct {ok} over {compared} scans", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
