"""Scaling-efficiency harness (port of ``icpslam_tpu/parallel/scaling.py``).

Times the batched multi-shard step (``parallel/dist_step``: registration
of the scan pairs and the edge-sharded graph solve) at a ladder of shard
counts and reports

    {"devices": n, "scans_per_sec": s, "efficiency": e}

per rung, where efficiency is *weak-scaling* efficiency: each shard
carries a fixed number of scan pairs, so ``e = (s_n / n) / s_1``. It also
reports the strong-scaling latency of the distributed solvers on a fixed
graph, and splits each rung's step into compute and collective time by
timing it again with ``dist_graph.ABLATE_COLLECTIVES``.

The ladder runs over shard counts on the mesh of this process. Without a
process group every rung is D shards of work on **one device**: the
numbers measure how the per-shard bodies and local reductions cost on
that device, not multi-chip scaling, and the result says so in its
``note``. Under a process group of W ranks each rung spreads D shards
over them (rungs not divisible by W are dropped).

    python -m icpslam_tpu_torch.parallel.scaling --devices 1,2,4,8 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional, Sequence

import numpy as np
import torch


def _render_pairs(n_pairs: int, capacity: int, n_points: int, device, seed: int = 0):
    """Host-rendered consecutive scan pairs over the synthetic room, as two
    distinct batches (timing loops alternate inputs)."""
    from icpslam_tpu_torch.io import synthetic

    world = synthetic.make_room_world(seed=seed, n_points=40000, size=24.0)
    t_np, q_np = synthetic.make_loop_trajectory(n_poses=2 * n_pairs + 2, radius=7.0, laps=0.8)
    clouds = [
        synthetic.pad(synthetic.render_scan(world, t_np[i], q_np[i], n_points=n_points,
                                            max_range=20.0, noise=0.01, seed=i), capacity)
        for i in range(2 * n_pairs + 2)
    ]

    def batch(lo):
        src = clouds[lo + 1: lo + 1 + n_pairs]
        tgt = clouds[lo: lo + n_pairs]
        return tuple(torch.from_numpy(np.stack([c[k] for c in part])).to(device)
                     for part in (src, tgt) for k in (0, 1))

    return batch(0), batch(1)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_scaling(
    device_counts: Sequence[int],
    pairs_per_device: int = 2,
    n_points: int = 3000,
    capacity: int = 4096,
    repeats: int = 4,
    solver_nodes: int = 64,
    icp_mode: str = "plane",
    device=None,
) -> List[dict]:
    """Weak-scaling throughput and strong-scaling solver latency ladder.
    Rung ``n`` registers ``n * pairs_per_device`` pairs on a mesh of ``n``
    shards; one warm-up call per input batch is left out of the times."""
    from icpslam_tpu_torch.config import IcpConfig
    from icpslam_tpu_torch.geometry import se3
    from icpslam_tpu_torch.graph import pose_graph as pg
    from icpslam_tpu_torch.parallel import dist_graph, dist_step, mesh as mesh_lib

    from icpslam_tpu_torch.utils.device import resolve

    dist = torch.distributed
    world = dist.get_world_size() if dist.is_initialized() else 1
    dev = resolve(device)
    counts = [n for n in device_counts if n % world == 0]
    dropped = [n for n in device_counts if n % world]
    if dropped:
        print(json.dumps({"metric": "scaling_rungs_dropped", "value": dropped,
                          "reason": f"not a multiple of the world size {world}"}),
              file=sys.stderr)
    if not counts:
        return []
    icfg = IcpConfig(mode=icp_mode, max_iterations=5, covariance_knn=8)
    batch_a, batch_b = _render_pairs(max(counts) * pairs_per_device, capacity, n_points, dev)

    # a fixed noisy loop-closed graph (strong scaling)
    K = solver_nodes
    rng = np.random.RandomState(0)
    E = K + K // 4
    ii = np.concatenate([np.arange(K - 1), rng.randint(0, K // 2, E - (K - 1))])
    jj = np.concatenate([np.arange(1, K), np.minimum(ii[K - 1:] + K // 2, K - 1)])
    edges = pg.EdgeSet(
        i=torch.as_tensor(ii, dtype=torch.int32, device=dev),
        j=torch.as_tensor(jj, dtype=torch.int32, device=dev),
        rel_t=torch.as_tensor(rng.randn(E, 3) * 0.1, dtype=torch.float32, device=dev),
        rel_q=se3.identity((E,), device=dev).q,
        info=(100.0 * torch.eye(6, device=dev)).expand(E, 6, 6).contiguous(),
        valid=torch.ones((E,), dtype=torch.bool, device=dev),
        count=torch.full((), E, dtype=torch.int32, device=dev),
        overflow=torch.zeros((), dtype=torch.int32, device=dev),
    )
    node_sets = [se3.Pose(t=torch.as_tensor(rng.randn(K, 3) * 2.0, dtype=torch.float32,
                                            device=dev),
                          q=se3.identity((K,), device=dev).q) for _ in range(4)]
    node_mask = torch.ones((K,), dtype=torch.bool, device=dev)

    results = []
    base_per_dev = None
    for n in counts:
        mesh = mesh_lib.make_mesh(n, device=dev)
        B = n * pairs_per_device
        pa, pb = tuple(x[:B] for x in batch_a), tuple(x[:B] for x in batch_b)

        def timed(step_fn):
            step_fn(*pa)  # warm
            step_fn(*pb)
            _sync(dev)
            t0 = time.perf_counter()
            for r in range(repeats):
                step_fn(*(pa if r % 2 == 0 else pb))
            _sync(dev)
            return (time.perf_counter() - t0) / repeats

        step = dist_step.make_batched_step(icfg, mesh)
        dt = timed(step)
        sps = B / dt
        # the same rung with the cross-rank collectives left out: the
        # difference is their cost (zero on a mesh of one process)
        try:
            dist_graph.ABLATE_COLLECTIVES = True
            dt_abl = timed(step)
        finally:
            dist_graph.ABLATE_COLLECTIVES = False
        compute_ms = dt_abl * 1000.0
        collective_ms = max(dt - dt_abl, 0.0) * 1000.0

        solve_ms = {}
        for solver in ("direct", "pcg", "schur"):
            def solve(nd, s=solver):
                return dist_graph.optimize(nd, edges, node_mask, mesh, iterations=5, mode="lm",
                                           linear_solver=s, sep_capacity=K)

            solve(node_sets[0])
            _sync(dev)
            t0 = time.perf_counter()
            for r in range(3):
                solve(node_sets[1 + r % (len(node_sets) - 1)])
            _sync(dev)
            solve_ms[solver] = (time.perf_counter() - t0) / 3 * 1000.0

        per_dev = sps / n
        if base_per_dev is None:
            base_per_dev = per_dev
        results.append({
            "devices": n,
            "pairs": B,
            "scans_per_sec": round(sps, 3),
            "efficiency": round(per_dev / base_per_dev, 4),
            # normalized to the smallest rung measured: a linear-scaling
            # fraction only when that rung is 1
            "efficiency_vs_devices": counts[0],
            "compute_ms": round(compute_ms, 3),
            "collective_ms": round(collective_ms, 3),
            "collective_frac": round(collective_ms / max(compute_ms + collective_ms, 1e-9), 4),
            "solve_ms": {k: round(v, 3) for k, v in solve_ms.items()},
        })
    return results


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=str, default="1,2,4,8",
                    help="comma-separated shard counts to ladder over")
    ap.add_argument("--pairs-per-device", type=int, default=2)
    ap.add_argument("--points", type=int, default=3000)
    ap.add_argument("--capacity", type=int, default=4096)
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--solver-nodes", type=int, default=64)
    ap.add_argument("--icp-mode", choices=["point", "plane"], default="plane")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the card)")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)

    from icpslam_tpu_torch.utils.device import resolve

    dev = resolve(args.device)
    rungs = measure_scaling(
        [int(x) for x in args.devices.split(",")],
        pairs_per_device=args.pairs_per_device, n_points=args.points, capacity=args.capacity,
        repeats=args.repeats, solver_nodes=args.solver_nodes, icp_mode=args.icp_mode,
        device=dev,
    )
    ranks = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    result = {
        "metric": "scaling_efficiency",
        "backend": dev.type,
        "device": kind,
        "ranks": ranks,
        "mode": "weak (fixed pairs/shard); solver latency is strong (fixed graph)",
        "note": (f"{ranks} rank(s): every rung runs its shards on {ranks} device(s), so this "
                 "measures the cost of D shards of work per device, not multi-chip scaling"),
        "rungs": rungs,
        "value": rungs[-1]["efficiency"] if rungs else None,
        "unit": "fraction of linear scaling at the largest rung",
    }
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
