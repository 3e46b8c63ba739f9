"""The two-process workload of ``scaling_dcn`` and ``elastic_dcn`` (the
port's counterpart of the worker scripts the JAX tools write out).

D = 4 shards over W = 2 ranks, 2 local shards on each: every rank joins
the process group through ``parallel/multihost.initialize`` (gloo on the
CPU, NCCL with rank r on ``cuda:r``), renders JAX's batch of 4 scan pairs
(``parallel/scaling._render_pairs(4, capacity=2048, n_points=1500)``)
and keeps its process-local half: the other rank's rows stay zero, and
``parallel/dist_step.batched_slam_step`` registers only the rank's own
rows, then gathers the relative poses and solves the 5-node chain
edge-sharded. Plane-mode GICP, 5 iterations, k = 8.

    python -m icpslam_tpu_torch.tools._dcn rank ADDR RANK DEVICE scaling|elastic FAULT POINTS CAPACITY
    python -m icpslam_tpu_torch.tools._dcn single DEVICE POINTS CAPACITY

The tools pass ``POINTS`` and ``CAPACITY`` from this module's constants
(JAX's sizes), which the CPU tests lower.

Rank 0 prints ``RESULT {...}``; each rank ends with ``proc<r>: <tag>-OK``.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from icpslam_tpu_torch.tools._common import sync

PAIRS = 4
RANKS = 2
SHARDS = 4
CAPACITY = 2048
POINTS = 1500
# the process group's timeout: an initialization or a collective whose
# peer is gone fails after it (the elastic launcher's watchdog ends such a
# rank before it)
GROUP_TIMEOUT_S = 300.0


def icp_config():
    from icpslam_tpu_torch.config import IcpConfig

    return IcpConfig(mode="plane", max_iterations=5, covariance_knn=8)


def check_devices(device: str) -> None:
    """Exit with an error before any rank is spawned unless the device
    can hold ``RANKS`` ranks: one CUDA card per rank (NCCL refuses two
    ranks on one GPU), or the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < RANKS:
        raise SystemExit(f"--device {device}: {RANKS} ranks need {RANKS} CUDA cards (NCCL "
                         f"refuses two ranks on one GPU) and this machine has {n}; pass "
                         "--device cpu for gloo ranks on the CPU")


def rank_device(device: str, rank: int) -> torch.device:
    dev = torch.device(device)
    return torch.device("cuda", rank) if dev.type == "cuda" else dev


def _timed(step, a, b, dev, repeats: int) -> float:
    """Seconds per call over ``repeats`` alternating calls, after one warm
    call on each batch."""
    step(*a)
    step(*b)
    sync(dev)
    t0 = time.perf_counter()
    for r in range(repeats):
        out = step(*(a if r % 2 == 0 else b))
    sync(dev)
    return (time.perf_counter() - t0) / repeats, out


def _local_half(batch, rank: int):
    """The batch with only this rank's rows: the other rows zeroed (their
    masks all False)."""
    per = PAIRS // RANKS
    out = []
    for x in batch:
        y = torch.zeros_like(x)
        y[rank * per:(rank + 1) * per] = x[rank * per:(rank + 1) * per]
        out.append(y)
    return tuple(out)


def _finite(res) -> bool:
    return bool(torch.isfinite(res.nodes.t).all() and torch.isfinite(res.nodes.q).all())


def run_rank(addr: str, rank: int, device: str, mode: str, fault: str = "none",
             n_points: int = POINTS, capacity: int = CAPACITY) -> dict:
    """One rank of the DCN workload. ``mode`` 'scaling' times the step as
    is and with ``dist_graph.ABLATE_COLLECTIVES``; 'elastic' times 6
    calls, after ``os._exit(41)`` on rank 1 when ``fault`` is 'crash'."""
    from icpslam_tpu_torch.parallel import dist_graph, dist_step, multihost
    from icpslam_tpu_torch.parallel import mesh as mesh_lib
    from icpslam_tpu_torch.parallel.scaling import _render_pairs

    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    multihost.initialize(coordinator_address=addr, num_processes=RANKS, process_id=rank,
                         device=dev, timeout_s=GROUP_TIMEOUT_S)
    try:
        mesh = mesh_lib.make_mesh(SHARDS, device=dev)
        batch_a, batch_b = _render_pairs(PAIRS, capacity=capacity, n_points=n_points, device=dev)
        ga, gb = _local_half(batch_a, rank), _local_half(batch_b, rank)
        step = dist_step.make_batched_step(icp_config(), mesh)
        if mode == "scaling":
            dt, out = _timed(step, ga, gb, dev, repeats=4)
            try:
                dist_graph.ABLATE_COLLECTIVES = True
                dt_abl, _ = _timed(step, ga, gb, dev, repeats=4)
            finally:
                dist_graph.ABLATE_COLLECTIVES = False
            result = {
                "processes": RANKS,
                "global_devices": SHARDS,
                "pairs": PAIRS,
                "points": n_points,
                "step_ms": round(dt * 1000.0, 3),
                "compute_ms": round(dt_abl * 1000.0, 3),
                "collective_ms": round(max(dt - dt_abl, 0.0) * 1000.0, 3),
                "collective_frac": round(max(dt - dt_abl, 0.0) / max(dt, 1e-9), 4),
                "poses_finite": _finite(out),
            }
        else:
            step(*ga)  # warm: the first collective round
            sync(dev)
            print(f"proc{rank}: WARM", flush=True)
            if fault == "crash" and rank == 1:
                # die abruptly mid-run: the peer is (or will be) inside a
                # collective with no one on the other end
                os._exit(41)
            t0 = time.perf_counter()
            for r in range(6):
                out = step(*(ga if r % 2 == 0 else gb))
            sync(dev)
            result = {
                "mode": "distributed", "processes": RANKS,
                "global_devices": SHARDS,
                "step_ms": round((time.perf_counter() - t0) / 6 * 1000.0, 3),
                "poses_finite": _finite(out),
            }
    finally:
        torch.distributed.destroy_process_group()
    return result


def run_single(device, n_points: int = POINTS, capacity: int = CAPACITY) -> dict:
    """The degraded re-dispatch: the same workload in one process, D = 4
    shards on ``device`` with no process group (nothing to hang on)."""
    from icpslam_tpu_torch.parallel import dist_step
    from icpslam_tpu_torch.parallel import mesh as mesh_lib
    from icpslam_tpu_torch.parallel.scaling import _render_pairs

    dev = torch.device(device)
    mesh = mesh_lib.make_mesh(SHARDS, device=dev)
    pa, pb = _render_pairs(PAIRS, capacity=capacity, n_points=n_points, device=dev)
    step = dist_step.make_batched_step(icp_config(), mesh)
    step(*pa)
    sync(dev)
    t0 = time.perf_counter()
    for r in range(6):
        out = step(*(pa if r % 2 == 0 else pb))
    sync(dev)
    dt = (time.perf_counter() - t0) / 6
    return {
        "mode": "single_process_degraded",
        "processes": 1,
        "shards": SHARDS,
        "pairs": PAIRS,
        "points": n_points,
        "device": str(dev),
        "step_ms": round(dt * 1000.0, 3),
        "poses_finite": _finite(out),
    }


def main(argv) -> int:
    if argv[0] == "single":
        print("RESULT " + json.dumps(run_single(argv[1], int(argv[2]), int(argv[3]))), flush=True)
        print("SINGLE-OK", flush=True)
        return 0
    _, addr, rank, device, mode, fault, n_points, capacity = argv
    rank = int(rank)
    result = run_rank(addr, rank, device, mode, fault, int(n_points), int(capacity))
    if rank == 0:
        print("RESULT " + json.dumps(result), flush=True)
    print(f"proc{rank}: {'DCN-SCALING' if mode == 'scaling' else 'ELASTIC'}-OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
