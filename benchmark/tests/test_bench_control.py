"""The precision control on the card: the reference at TF32 against the
reference at float32 must come out not correct (``benchmark/control.py``),
over the cell's own ``check_scans``: on the idealized render the two can
agree bit for bit over a drive's first tens of scans (``PERF.md`` §4)."""

import json
import os
import subprocess
import sys

import pytest

from yardstick import spec


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["kitti_hdl64.revisit", "kitti_hdl64_deskew.one_way"])
def test_tf32_control_is_not_correct(card, workload):
    out = subprocess.run([sys.executable, os.path.join(spec.BENCH_DIR, "control.py"),
                          "--workload", workload, "--seeds", "6000000001"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    assert rows and not any(r["control_correct"] for r in rows), rows
