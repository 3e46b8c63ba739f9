"""Multi-process elastic recovery: detect a dead peer, re-dispatch
degraded (port of the JAX package's ``tools/elastic_dcn.py``).

The launcher starts ``scaling_dcn``'s two-rank workload (``tools/_dcn.py``),
watches the ranks instead of blocking on them, and on a peer's failure
(a crash, or a rank still running past the watchdog after a peer died:
a survivor can hang inside a collective with no one on the other end)
ends the remaining ranks by their exact PIDs (terminate, then kill) and
re-dispatches the same workload in one process, D = 4 shards with no
process group, on the same device (:func:`run_single`). The artifact
records the failure, the detection path and the degraded result.

Fault injection: ``--inject-fault crash`` makes rank 1 exit (code 41)
after its warm call, mid-run, the hardest point: the survivor is inside a
collective; ``--inject-fault none`` runs the healthy path. Devices as
``scaling_dcn``: ``--device cuda`` (the default) needs a card per rank
and exits with an error before spawning anything without them; ``--device
cpu`` runs gloo ranks.

    python -m icpslam_tpu_torch.tools.elastic_dcn --inject-fault crash [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from icpslam_tpu_torch.tools import _dcn
from icpslam_tpu_torch.tools._common import (REPO, add_device_flag, artifact_path, card,
                                             result_line, write_artifact)
from icpslam_tpu_torch.tools.scaling_dcn import spawn_ranks

run_single = _dcn.run_single

DEADLINE_S = 900.0


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--inject-fault", choices=["none", "crash"], default="none")
    ap.add_argument("--out", type=str, default=artifact_path("elastic_dcn.json"))
    ap.add_argument(
        "--watchdog", type=float, default=120.0,
        help="seconds a rank may run on after a peer's death before the launcher declares "
        "the group dead and ends it (a survivor can hang inside a collective; only the "
        "launcher can free it)",
    )
    add_device_flag(ap)
    return ap


def _end(procs) -> None:
    """Terminate, then kill, every rank still running, by its exact PID."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)


def watch(procs, watchdog: float, deadline_s: float = DEADLINE_S):
    """Poll the ranks' exact PIDs until all exit, or a peer died and the
    rest outlived ``watchdog``, or the deadline passed; every rank has
    exited when it returns. Returns the failure, or None."""
    deadline = time.time() + deadline_s
    first_death = None
    try:
        while time.time() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes):
                return f"worker exit codes {codes}" if any(c != 0 for c in codes) else None
            dead = [i for i, c in enumerate(codes) if c is not None and c != 0]
            if dead and first_death is None:
                first_death = time.time()
                print(f"detected dead peer(s) {dead} (codes {codes}); "
                      f"watchdog {watchdog}s on survivors", file=sys.stderr)
            if first_death is not None and time.time() - first_death > watchdog:
                return f"peer(s) {dead} died; survivors hung past {watchdog}s watchdog"
            time.sleep(0.5)
        return "launcher deadline exceeded"
    finally:
        _end(procs)


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    _dcn.check_devices(args.device)

    with tempfile.TemporaryDirectory(prefix="elastic_") as tmp:
        logs = [open(os.path.join(tmp, f"w{i}.log"), "w+") for i in range(_dcn.RANKS)]
        try:
            procs = spawn_ranks(args.device, "elastic", args.inject_fault, stdout=logs)
            failure = watch(procs, args.watchdog)
            outs = []
            for lg in logs:
                lg.flush()
                lg.seek(0)
                outs.append(lg.read())
        finally:
            for lg in logs:
                lg.close()

    backend = ("cuda (2 OS processes, one card each, NCCL)" if args.device.startswith("cuda")
               else "cpu (2 OS processes, loopback gloo via torch.distributed)")
    artifact = {
        "metric": "elastic_dcn_recovery",
        "inject_fault": args.inject_fault,
        "backend": backend,
        "card": card(args.device),
        "worker_pids": [p.pid for p in procs],
    }
    dist_result = result_line(outs[0])
    if failure is None and dist_result is not None:
        artifact.update(degraded=False, distributed=dist_result)
    else:
        # --- elastic re-dispatch: the same workload, one process ---------
        print(f"re-dispatching single-process (reason: {failure})", file=sys.stderr)
        device = str(_dcn.rank_device(args.device, 0))
        t0 = time.time()
        sp = subprocess.run(
            [sys.executable, "-m", "icpslam_tpu_torch.tools._dcn", "single", device,
             str(_dcn.POINTS), str(_dcn.CAPACITY)],
            cwd=REPO, capture_output=True, text=True, timeout=DEADLINE_S,
        )
        if sp.returncode != 0 or "SINGLE-OK" not in sp.stdout:
            raise RuntimeError(f"degraded re-dispatch failed:\n{sp.stdout[-2000:]}\n"
                               f"{sp.stderr[-2000:]}")
        artifact.update(
            degraded=True,
            failure=failure,
            detection="launcher poll of exact worker PIDs + hang watchdog",
            redispatch=result_line(sp.stdout),
            redispatch_wall_s=round(time.time() - t0, 1),
        )
    write_artifact(args.out, artifact)
    print(json.dumps(artifact))
    return 0


if __name__ == "__main__":
    sys.exit(main())
