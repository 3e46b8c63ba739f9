"""Two-process scaling rung with compute-against-collective attribution
(port of the JAX package's ``tools/scaling_dcn.py``).

Two rank processes (``tools/_dcn.py``) join one process group over
``parallel/multihost.initialize`` at a loopback address, hold D = 4
shards between them (2 each), feed their process-local halves of a batch
of 4 scan pairs to the batched multi-shard step (registration of each
rank's pairs, gathered; the chain solved edge-sharded), and time each
call twice: as is, and with every cross-rank collective replaced by a
local no-op (``dist_graph.ABLATE_COLLECTIVES``), which splits the step
into ``{compute_ms, collective_ms}``.

``--device cuda`` (the default) puts rank r on ``cuda:r`` under NCCL; with
fewer than 2 cards the tool exits with an error before it spawns a rank
(NCCL refuses two ranks on one GPU, and gloo does not carry
``all_gather_into_tensor`` on CUDA tensors). ``--device cpu`` runs the
JAX tool's loopback recipe over gloo. Processes that share one machine's
cores make the efficiency meaningless; the artifact records the
attribution and the working recipe.

    python -m icpslam_tpu_torch.tools.scaling_dcn [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from icpslam_tpu_torch.tools import _dcn
from icpslam_tpu_torch.tools._common import (REPO, add_device_flag, artifact_path, card,
                                             free_port, result_line, write_artifact)

WORKER_TIMEOUT_S = 900


def spawn_ranks(device: str, mode: str, fault: str = "none", stdout=subprocess.PIPE):
    """Start the ``_dcn.RANKS`` rank processes at a fresh loopback address."""
    addr = f"127.0.0.1:{free_port()}"
    outs = stdout if isinstance(stdout, list) else [stdout] * _dcn.RANKS
    return [
        subprocess.Popen(
            [sys.executable, "-m", "icpslam_tpu_torch.tools._dcn", "rank", addr, str(rank),
             device, mode, fault, str(_dcn.POINTS), str(_dcn.CAPACITY)],
            cwd=REPO, stdout=outs[rank], stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(_dcn.RANKS)
    ]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=str, default=artifact_path("scaling_dcn2.json"))
    add_device_flag(ap)
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    _dcn.check_devices(args.device)
    procs = spawn_ranks(args.device, "scaling")
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or "DCN-SCALING-OK" not in out:
            raise RuntimeError(f"proc{rank} failed:\n{out[-3000:]}")
    rung = result_line(outs[0])
    backend = ("cuda (2 OS processes, one card each, NCCL)" if args.device.startswith("cuda")
               else "cpu (2 OS processes, loopback gloo via torch.distributed)")
    artifact = {
        "metric": "scaling_dcn_attribution",
        "backend": backend,
        "note": "co-located processes share one host's cores, so efficiency is not "
        "meaningful here: the artifact proves the cross-process measurement chain "
        "(rendezvous, process-local input halves, collectives across processes, "
        "ablation attribution); collective_ms counts the mesh's cross-rank collectives "
        "(all_reduce, all_gather_into_tensor), which the ablation replaces by local copies",
        **rung,
        "card": card(args.device),
    }
    write_artifact(args.out, artifact)
    print(json.dumps(artifact))
    return 0


if __name__ == "__main__":
    sys.exit(main())
