"""The benchmark of icpslam_tpu_torch on an NVIDIA GPU.

    python3 benchmark/run.py --workload kitti_hdl64.revisit --seed 7 --seconds 30 --trace 0

Runs one cell of ``BENCHMARK.json`` (from the root of a checkout) on the
card it is started on: renders the cell's drive from ``--seed`` in worker
processes, warms the program up, replays the drive back to back through
``icpslam_tpu_torch.io.runner.run_slam`` for ``--seconds``, then checks
what the window produced against the plain reference
(``benchmark/slamref``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics, each
read by ``benchmark/metrics/<name>.py``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its
limit; the same numbers end standard error.

Exits non-zero, with no result, without a CUDA device (or with fewer
than the cell asks for), when the program cannot be imported, or when a
module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

_T_IMPORT = time.perf_counter()
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
RENDER_WORKERS = 7


def _process_age() -> float:
    """Seconds since this process started (Linux: ``/proc``), else since
    this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True, help="makes the scans; any integer >= 0")
    ap.add_argument("--seconds", type=float, required=True, help="the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="1: report the per-layer metrics from a profiled window")
    return ap


def _cache_env() -> None:
    """Kernel and build caches at fixed paths inside the checkout; the
    process's thread counts and library switches."""
    cache = os.path.join(ROOT, "_bench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    # one thread a process: the load on the host comes from the drive loop
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    # libraries that would load JAX or Flax on their own stay off it
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    t0 = time.perf_counter() - _process_age()  # process start on the perf_counter clock
    if args.seed < 0 or args.seconds <= 0:
        print("run.py: --seed must be >= 0 and --seconds > 0", file=sys.stderr)
        return 2
    _cache_env()
    # the program from the checkout's root, the yardstick beside this file
    sys.path[:0] = [BENCH_DIR, ROOT]
    from yardstick import spec, traffic as traffic_mod

    cell = spec.load_cell(args.workload, trace=bool(args.trace), root=ROOT)
    sensor, slam_dict = cell.config["sensor"], cell.config["slam"]
    # the render runs in worker processes while torch and the card start
    render = traffic_mod.render_sequence(cell.traffic, sensor, args.seed,
                                         int(slam_dict["max_raw_points"]),
                                         workers=RENDER_WORKERS)
    try:
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"run.py: the cell needs {cell.chips} CUDA device(s); "
                  f"torch.cuda.is_available() {torch.cuda.is_available()}, {n} found",
                  file=sys.stderr)
            return 2
        from yardstick import bench  # the program: fails here in a checkout without it

        return bench.run(cell, args, render, t0)
    finally:
        render.stop()

if __name__ == "__main__":
    sys.exit(main())
