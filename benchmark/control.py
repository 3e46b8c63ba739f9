"""The precision control of the comparison that decides ``correct``.

    python3 benchmark/control.py --workload kitti_hdl64.revisit --seeds 11,12,13

The configuration states float32 with TF32 off. The control puts the
reference in the program's place, computed one step below that: with
TF32 matrix products on. For each seed it renders the cell's scans as a
run does, replays the first ``check_scans`` (or ``--scans``) through the
reference at float32 and at TF32, and prints the comparison's numbers of
the TF32 replay against the float32 one, beside their limits
(``yardstick/compare.py``), and whether the control comes out correct.
Benchmark runs do not run it; it needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--scans", type=int, default=None, help="default: the traffic's check_scans")
    args = ap.parse_args(argv)
    sys.path[:0] = [BENCH_DIR, ROOT]
    import torch

    from yardstick import compare, reference, spec
    from yardstick import traffic as tr

    if not torch.cuda.is_available():
        print("control.py: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload, trace=False, root=ROOT)
    sensor, slam = cell.config["sensor"], cell.config["slam"]
    n = int(args.scans or cell.traffic["check_scans"])
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        t, q = tr.trajectory(cell.traffic, sensor, seed)
        scans = tr.render_sequence(cell.traffic, sensor, seed, int(slam["max_raw_points"]),
                                   count=n).result()
        runs = [reference.replay(scans, slam, t[0], q[0], float(sensor["rate_hz"]), dev,
                                 graph_at=[n], tf32=tf) for tf in (False, True)]
        (ref, ref_graphs), (low, low_graphs) = runs
        nums, compared = compare.numbers([low], ref, [(n,) + low_graphs[n]], ref_graphs)
        ok, rows = compare.verdict(nums, compared)
        failed_all &= not ok
        print(json.dumps({"workload": args.workload, "seed": seed, "scans": compared,
                          "control_correct": ok, "numbers": nums,
                          "limits": {k: lim for k, _, lim in rows},
                          "seconds": time.perf_counter() - t0}), flush=True)
    print(f"control: {'failed on every seed' if failed_all else 'passed on some seed'}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
