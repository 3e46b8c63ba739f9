#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``icpslam_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--out results.json]

Phases, in order; a failed phase raises and the exit code is non-zero:

1. device and build: requires CUDA, prints the card's name and power limit
   (``nvidia-smi``) and builds the CUDA kernels from ``icpslam_tpu_torch/csrc``;
2. K1 (``nn1``) against its plain PyTorch version at the main-path shapes,
   equal d² bits and equal indices: 8192 × 8192 voxel-filtered scans,
   8192 queries against a 262,144-point map at ~22k fill with
   ``valid_len``, masked, all-masked, 1 km from the origin, and the
   adversarial cases of the tile skip (``_grid_cloud``): exact duplicates
   in different tiles visited out of index order, a target exactly at the
   AABB-bound distance, ``valid_len`` ending mid-tile, one query hundreds
   of metres from every target, ragged N and M;
3. K2 (``knn``) against its plain version, likewise: self-kNN at 8192 with
   k = 10 and 16, duplicates inside the k-list, fewer live targets than
   k, all masked, the far query, ragged N and M, the AABB-bound case;
4. the room-loop sentinel: 20 poses of the runner's ``--synthetic`` config;
5. the full-size slice: 40 scans of the KITTI proxy (idealized render)
   under ``kitti_config()`` through ``slam_step``;
6. K3 (``radius_moments``) against its plain version: self-moments of a
   voxel-filtered 8192-point scan, hard cutoff (r = 1.0 m) and taper
   (σ = 0.5 m), 70% of targets masked, all masked, 1 km from the origin,
   and the cases of its tile skip: the grid cloud's duplicates across
   tiles, a target at d² == r² exactly and one at a tile's box edge just
   inside r, ragged N and M, a query 700 m away. The hard count must be
   equal on every row, the moments within MOM_ABS + MOM_REL·|plain|, and
   the kernel's pair counter equal to ``swept_pairs_plain``;
7. K4 (``nn1_matmul``) against its plain version and beside K1, on the
   8192 × 8192 scan and the 8192 × 262,144 map cases of phase 2, ragged N
   and M, and ``valid_len`` ending mid-tile;
8. the radius mission: 500 scans of the KITTI proxy under
   ``kitti_config()`` with radius covariances in both ICP stages
   (``radius_config()``), rendered beforehand in RENDER_WORKERS processes
   as phase 9's, through ``runner.run_slam`` — the run that
   reaches loop closure and the incremental window solve at full width;
9. the long mission: 1,800 scans of the KITTI proxy under plain
   ``kitti_config()`` (k-NN covariances through K2) through
   ``runner.run_slam``, about 3.6 laps: the live graph outgrows the
   256-node bucket, so full solves run PCG, and the 512-keyframe store
   fills, so every later keyframe first marginalizes one. ms/scan median
   and p90 before the first PCG solve, from it to the first eviction, and
   after; host syncs per scan, dropped edges, peak memory;
10. the three linear solvers on the graph phase 9 leaves (512 nodes, its
   edges and mask): ``optimize`` with 'direct', 'pcg' and 'schur' (chunk
   64, separator capacity 64), LM with 3 iterations as ``slam_step`` runs
   them: CUDA-event ms (median of 5 calls), initial and final cost, the
   separator count and whether Schur fell back to the direct solve; PCG's
   and Schur's poses within SOLVER_DIST of direct's. Then the captured
   solves (``graph/captured.py``) against the eager ones: direct on the
   graph's 64-, 128- and 256-node prefixes (their buckets), PCG on all
   512 nodes, and the window solve (W = 64): poses within CAPTURED_DIST,
   final cost within CAPTURED_COST relative, replay and eager ms (CUDA
   events, median of 5);
11. the long mission deferred: the same scans as phase 9 (rendered once
   for both, in RENDER_WORKERS processes, held to the runner's stream)
   with ``defer_optimization`` and ``pipeline/deferred.py``'s
   backend as the runner configures it (``check_every`` =
   ``keyframes_window``, ``max_lag`` 8): launched and folded (equal after
   ``flush``), evictions, PCG solves, folds across an eviction, graph
   captures; ms/scan median, p90, p99 and max over all scans and over the
   scans that launched or folded, beside phase 9's (all scans and its
   optimize scans); host syncs per scan and peak memory, graph pools
   included;
12. the profile: ``utils/profiling.trace`` over phase 5's 40 scans, inline and then deferred, each after one unprofiled
   warm run, with ``torch.cuda.set_sync_debug_mode("warn")`` on; the
   traces go to ``_traces/`` (git-ignored). Device-busy share, kernels
   and host launch calls per scan, the five costliest device ops, and the
   host syncs per scan by source: the counted ``to_host`` reads, the step
   timer's stream sync and the rest (implicit);
13. the physics mission: 500 scans of the KITTI proxy rendered as the
   runner's ``--kitti-proxy`` renders them by default (motion distortion
   across the sweep, noise growing with range, 8% dropout, moving
   traffic; ``runner.proxy_physics()``), under ``kitti_config()`` at full
   width with the runner's default in-loop de-skew (coupled, freed source
   twist), through ``runner.run_slam``: ATE ≤ PHYSICS_ATE, ≥ 90% of the
   scans accepted, K1 launched in every registered scan; ms/scan median,
   p90, p99 and max, GN iterations, host syncs and K1/K2 launches per
   scan, loop-closure edges, and the host's render seconds apart; then
   the same drive with the runner's prefetch depth 0 (scans uploaded
   inline instead of three ahead on a thread) and at depth 3 again: their
   times beside the first drive's, and records equal to it bit for bit;
14. the INS de-skew at ingest: the same 500 scans de-skewed on the host
   (``synthetic.ins_deskew_stream``, equal to the runner's ``--deskew``
   stream) under plain ``kitti_config()``: ATE ≤ INS_ATE;
15. the other in-loop modes on the first 60 of those scans: coupled with
   the constant-velocity tie (ATE ≤ CV_ATE), ``joint`` and ``alternate``
   (2 rounds) with no ATE limit (JAX measured both as inferior) — all 60
   scans with finite poses and K1 launched; their ATEs beside JAX's;
16. the voxel map: phase 5's 40 scans with ``map_backend='voxel'``: ATE ≤
   VOXEL_ATE, the map size and overflow, and K2 launched on the NN cloud
   of every refinement beside the odometry's;
17. the KITTI tree: phase 13's 500 scans written by ``io/kitti.write_tree``
   (4-column ``.bin`` files, ``Tr``, jittered stamps, cam0 poses) into a
   temporary directory of the checkout, removed afterwards, and driven
   through the runner's own entry point, ``runner.main(["--kitti", ...,
   "--deskew-rounds", "1", "--deskew-free-twist", "--out", ...,
   "--summary-out", ..., "--save-state", ..., "--html", ...])``: the
   native loader built from ``native/scanio.cpp`` reads it (``loader`` =
   native), ATE ≤ PHYSICS_ATE, ≥ 90% accepted, K1 and K2 launched in
   every registered scan, and every product read back (the trajectory
   ``.npz``, the summary, the checkpoint through ``checkpoint.load``, the
   viewer); ms/scan median, p90, p99 and max, host syncs and K1/K2
   launches per scan beside phase 13's;
18. resume: the tree's first RESUME_AT scans with ``--end`` and
   ``--save-state``, then ``--resume`` from that checkpoint with
   ``--start`` to the end: the resumed run starts from the checkpoint's
   keyframe count with a re-rendered, non-empty map, every pose finite,
   the tail's ATE ≤ PHYSICS_ATE, printed beside phase 17's over the same
   scans;
19. ``--chunk``: phase 5's 40 scans through ``runner.run_slam`` in chunks
   (``slam.run_scans``) of 8 and of 6 (a tail of 4 padded with 2 empty
   scans): the 18-float records, trajectory included, equal to phase 5's
   one-step drive bit for bit;
20. the sharded map (``parallel/``): phase 5's 40 scans with
   ``map_backend='sharded'`` on a mesh of 1 shard, records equal to phase
   16's voxel drive bit for bit, and of SHARDS = 8 shards (no process
   group): the trajectory within SHARDED_DIST of phase 16's, the shard
   sizes and overflows summing to its map's, equal keyframe,
   optimization and loop-closure counts; ms/scan, host syncs, K1/K2
   launches per scan and peak memory beside phase 16's;
21. the dist-* solvers on phase 9's 512-node graph over 8 shards
   (``parallel/dist_graph.py``), LM with 3 iterations as in phase 10:
   poses within SOLVER_DIST and the final cost within DIST_COST_REL
   relative of the replicated solver's, eager and captured CUDA-event
   ms (Schur eager only: its ``ok`` is read on the host), Schur's
   separator count and fallback; then phase 5's scans with
   ``graph_incremental=False`` and 'dist-schur' against 'direct': the
   trajectory within DIST_SCHUR_DIST;
22. the batched multi-shard step (the path of JAX's
   ``dryrun_multichip``): BATCH_PAIRS consecutive KITTI-proxy scan pairs
   voxel-filtered to 8,192 points, plane-mode GICP, over 8 shards, with
   the sharded map built and queried (``batched_slam_step_with_map``):
   finite poses, the ATE ≤ BATCH_ATE, K1 launched on every pair, K2 on
   both clouds of each; the same graph through dist-pcg and dist-schur
   within SOLVER_DIST; ``sharded_nn`` over 8 shards on 8192 queries
   against the 262,144-point map: each shard's block equal to K1 on that
   block, d² bits and indices, and within MOM_ABS + MOM_REL·d² of one K1
   call on all queries (K1 centres on its queries' centroid, which differs
   per block);
23. NCCL at world size 1: a process group of one rank, so that every
   collective of the mesh goes through ``dist.all_reduce`` /
   ``all_gather_into_tensor`` on the card: phase 20's 8-shard drive
   (records equal bit for bit), phase 21's dist-direct solve (poses within
   NCCL_DIST) and ``sharded_nn`` (equal) against the mesh without a group;
   the group is destroyed afterwards.

Phases 24-29 run the port's tools (``icpslam_tpu_torch/tools/``,
``icpslam_tpu_torch/examples/``) as a user runs them, ``python -m ...`` in
a subprocess with a time limit, in a git-ignored work directory of the
checkout (``_chip_tools_*/``, removed afterwards), and read their
artifacts back; a tool counts the kernels' launches in its own
processes and reports them. Phases 24-26 run on a thread of their own
(subprocesses only: nothing of the script's CUDA state or launch
counts): 26 beside phases 13-15, then 24 and 25, on phase 13's scans,
beside phases 16-23; 27-29 run one after another once they are done,
with nothing beside them:

24. ``tools.endurance --scans ENDURANCE_SCANS`` on phase 13's first scans,
   written as the runner's scan cache (tag 1): six runner processes (A,
   B1 + B2 resumed, C at a 1.0 m gate, C_frozen, D deferred), each with
   finite poses and K1/K2 launched in every registered scan; A's, B2's
   and D's ATE, the resume's end gap and tail RMSE ≤ PHYSICS_ATE; D
   launched = folded; JAX's artifact keys and the card; each run's
   ms/scan and peak memory beside phase 13's (C's store does not fill at
   this depth: the full-length run shows the eviction);
25. ``tools.kitti_tree_run`` on the same cache: loader native, ATE ≤
   PHYSICS_ATE, K1/K2 in every registered scan;
26. ``tools.sharded_endurance --scans SHARDED_SCANS`` (3 laps; 8 shards on
   the card, no process group, and its voxel twin): a shard overflowed,
   evictions and solves, finite poses, both ATEs ≤ SHARDED_END_ATE and
   within SHARDED_END_DELTA of each other;
27. ``tools.probe_step_budget`` and ``tools.probe_scan_to_map`` at the JAX
   probes' configuration: each variant's ms/scan with its spread, each
   knob's ms and iteration counts, all finite, the counts within [1,
   max_iterations];
28. ``tools.scaling_dcn`` and ``tools.elastic_dcn --device cuda`` refuse
   one card within 10 s before spawning a rank (on two cards or more they
   run there); then ``elastic_dcn.run_single`` on the card: D = 4 shards,
   4 pairs, finite poses, K1 and K2 on every pair;
29. ``examples.synthetic_city`` at its defaults with every export read back
   (TUM, PLY, graph JSON, the checkpoint through ``checkpoint.load``, the
   viewer), ≥ 1 loop closure, ATE ≤ max(CITY_ATE_FLOOR, 1.5 ×
   JAX_CITY_ATE); ``examples.sharded_streaming --poses 16 --devices 8``:
   a finite ATE, K1 and K2 launched, and at the end and at the run's
   largest map (a solve clears it, and at scan 16 it is empty) the
   shards' sizes summing to the mesh's total; the largest is not empty
   and spread over more than one shard.

30. the odometry front end as an entry point of its own, on phase 5's 40
   scans (rendered once, after phase 5, for phases 30 and 12) at
   ``kitti_config()``'s full width: ``odometry.run_scans`` in chunks of
   ODOM_CHUNK (JAX's ``bench_odometry``) and ``odometry_step(state, scan,
   cfg)`` one scan at a time, JAX's contract: every output and the final
   state bit-equal, K1 and K2 launched in every registered scan, ≥ 90%
   accepted, finite poses; each drive also runs first, untimed, under
   ``set_sync_debug_mode('warn')`` (equal outputs) for its host syncs;
   ms/scan, syncs and K1/K2 launches per scan and the odometry-only ATE
   (no limit); ``drain_accumulator`` within 1e-4 m of
   ``se3.relative(initial, final)`` and identity after a second drain;
   ``point_map.exact_nn`` equal to ``exact_nn_with_covs``'s result (the
   winning points, d² and found, bit for bit) on phase 2's map.

Phase 12 runs after phase 30, last. Each path (phases 4, 5, 8, 9, 11,
13-20, 23, 28's ``run_single`` and both drives of 30) is driven with every
launch count set to 0 just before it and read just after. Kernel times (``ms``) are the device
time per wrapper call, calls enqueued back to back behind a spin kernel
(``_device_ms``); plain versions are timed by CUDA events around single
calls (``_timed``). ``bound_ms`` is the least time the card could take
for the same work (``_bound``). For K1 and K2 it counts the (query, live
target) pairs this run's tile skip left to evaluate (``pairs_share`` of
them, from the kernels' pair counter; K3 likewise, over the pairs its
tile skip swept); ``bound_all_pairs_ms`` counts all of them, the bound of
the earlier records. The line before the last is a
JSON object with one entry per kernel; the last line is ``{"ok": true,
"device": {...}}``. The script needs no JAX.

The script stops every process it starts, whether it passes or fails: it
makes itself the subreaper of its descendants at its start, so that an
orphan of a tool's process is adopted by it, and when ``main`` returns or
raises it closes multiprocessing's resource tracker (started by phase 9's
render pool) and kills and waits for every descendant still alive, naming
each on stderr. SIGTERM (a time limit's signal) ends it the same way.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

# K3 against its plain version: mean and covariance (and the tapered
# weight sum) within MOM_ABS + MOM_REL·|plain| (the sums run in another
# order); the hard count is equal on every row, those with a pair within
# BOUNDARY·r² of the radius included (both decide d² < r² on the same
# float32 d²)
MOM_ABS = 1e-5
MOM_REL = 1e-5
BOUNDARY = 1e-5
# K4 (matmul form) rounds with its operands: tol = K4_REL·(|q_c|² + |t_c|²) + K4_ABS
K4_REL = 4e-7
K4_ABS = 1e-6
# published peaks of one H100 SXM (FP32 outside the tensor cores; HBM3)
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
MISSION_SCANS = 500
MISSION_ATE = 0.10
LONG_SCANS = 1800
# The long mission's second lap closes a loop at every keyframe, and the
# trajectory error grows there before the first PCG solve and before any
# eviction: ATE 0.14 m over the 773 scans before PCG (phase 9 prints it),
# 0.26 m over 1,800, and 0.27 m with the direct solve and no eviction
# (configs/kitti_direct_1024.yaml). The JAX package shows the same growth
# on a reduced-size drive (tests/long_mission_parity.py; PERF.md §6).
# The limit catches a lost track, which costs metres.
LONG_ATE = 0.35
# PCG's and Schur's poses against the direct solve's on the 512-node graph
# (float32; looser than the unit tests' 1e-3 m on 12-300 nodes)
SOLVER_DIST = 5e-2
# a captured solve against the eager one: the same kernels in the same
# order; the scatter-adds' atomics sum in another order
CAPTURED_DIST = 1e-4
CAPTURED_COST = 1e-4
TRACE_DIR = "_traces"
# the physics proxy (phases 13-15): the JAX package's recorded ATE over
# 500 poses is 0.3288 m with the coupled free-twist de-skew, 0.1769 m
# with the INS de-skew and 7.78 m without de-skew; the limits catch a
# de-skew that does not work
PHYSICS_SCANS = 500
PHYSICS_ATE = 0.50
INS_ATE = 0.30
MODES_SCANS = 60
CV_ATE = 0.10
# JAX's 60-pose ATEs of the two other modes (docs/DESIGN.md §14, the
# reduced-width CPU config), printed beside the port's
JAX_MODE_ATE = {"joint": "0.61-5.5", "alternate": "0.095"}
VOXEL_ATE = 0.10
SLICE_SCANS = 40
# the KITTI tree (phases 17-18): phase 13's scans written to disk and read
# back through the native loader; the resume splits the run here
RESUME_AT = 250
TREE_SEQ = "99"
# phases 20-23: the mesh of shards (parallel/mesh.py) without a process
# group and under NCCL at world size 1. SHARDED_DIST and DIST_SCHUR_DIST
# are JAX's own tolerances (tests/test_sharded_slam.py: the sharded map
# against the voxel map, dist-schur against the replicated direct
# solver), DIST_COST_REL that of tests/test_parallel.py (a dist solve's
# final cost against the replicated one's: the edge-sharded sums reduce in
# another order, which CG's 50 steps amplify); NCCL_DIST: an all-reduce over one rank changes no bit, the
# solve's poses are held to 1e-6 m all the same
SHARDS = 8
SHARDED_DIST = 1e-4
DIST_SCHUR_DIST = 2e-3
DIST_COST_REL = 1e-2
NCCL_DIST = 1e-6
BATCH_PAIRS = 15     # JAX's dryrun_multichip(8): B = 2·8 − 1, K = 16 nodes
BATCH_ATE = 0.10
# phase 19: run_scans chunks over the slice; 40 = 5 x 8, and 6 leaves a
# tail of 4 scans padded with 2 empty ones
CHUNKS = (8, 6)
# phases 24-26: the depth of the endurance and tree runs (phase 13's first
# scans; six runner processes, each ~10 s of start-up on top) and of the
# sharded endurance drive (3 laps, as JAX's tool runs max(3, scans / 120))
ENDURANCE_SCANS = 30
SHARDED_SCANS = 240
# phase 30: the odometry front end's chunk (JAX's bench_odometry drives
# run_scans in chunks of 10)
ODOM_CHUNK = 10
# processes that render the long mission's scans (each scan's render
# depends on its index and pose alone)
RENDER_WORKERS = 8


def _timed(fn, iters: int = 30, warmup: int = 3) -> float:
    """Median ms of ``fn()`` over ``iters`` CUDA-event-timed calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _device_ms(fn, calls: int = 20, reps: int = 7) -> float:
    """Median device ms per ``fn()`` call, ``calls`` calls enqueued back to
    back behind a spin kernel, so that host dispatch leaves no gap between
    them on the device. A repetition whose enqueuing outlasted the spin is
    repeated with twice the spin; raises past ~1 s of spin."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    spin = 20_000_000  # cycles, ~10 ms
    times = []
    while len(times) < reps:
        s0 = torch.cuda.Event(enable_timing=True)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        s0.record()
        torch.cuda._sleep(spin)
        a.record()
        h0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_ms = (time.perf_counter() - h0) * 1e3
        b.record()
        b.synchronize()
        if host_ms >= s0.elapsed_time(a):
            if spin >= 2**31:
                raise AssertionError(f"enqueuing {calls} calls took {host_ms:.2f} ms, longer "
                                     f"than the {s0.elapsed_time(a):.2f} ms spin")
            spin *= 2
            continue
        times.append(a.elapsed_time(b) / calls)
    times.sort()
    return times[len(times) // 2]


def _pairs(fn) -> int:
    """(query, live target) pairs that one call ``fn(pairs)`` of K1, K2 or
    K3 evaluated, from the kernels' pair counter."""
    import torch

    pairs = torch.zeros(1, dtype=torch.int64, device="cuda")
    fn(pairs)
    return int(pairs.item())


def _equal(name: str, idx_k, d_k, idx_p, d_p) -> float:
    """Kernel and plain version must agree bit for bit on d² and exactly
    on indices (1-NN (N,) or k-NN (N, k)). Returns the largest |d² error|
    over finite entries (0.0 when they agree)."""
    import torch

    if not torch.equal(d_k.view(torch.int32), d_p.view(torch.int32)):
        bad = d_k.view(torch.int32) != d_p.view(torch.int32)
        raise AssertionError(f"{name}: {int(bad.sum())} d2 entries differ in their bits")
    if not torch.equal(idx_k, idx_p):
        raise AssertionError(f"{name}: {int((idx_k != idx_p).sum())} indices differ")
    fin = torch.isfinite(d_p)
    return float((d_k[fin] - d_p[fin]).abs().max()) if fin.any() else 0.0


def _bound(ops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the FP32 operations over the
    card's FP32 peak and the bytes moved (each input read once, each
    output written once) over its memory rate."""
    t_ops = ops / PEAK_FP32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _nn_bound(n: int, m: int, pairs: float, out_bytes_per_query: int):
    """1-NN / k-NN style search: 8 FP32 operations per (query, target) pair
    (3 subtractions or the cross term, 3 multiplies, 2 adds); bytes of the
    n queries, the first m rows of t and mask, and the outputs."""
    return _bound(8.0 * pairs, 12 * n + 13 * m + out_bytes_per_query * n)


def phase_device_and_build():
    import torch

    from icpslam_tpu_torch.ops import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    card = smi[torch.cuda.current_device()] if smi else "nvidia-smi: no output"
    print(card)
    t0 = time.perf_counter()
    cuda_build.load()
    print(f"[1] device {torch.cuda.get_device_name(0)}; kernels built in "
          f"{cuda_build.load.build_seconds:.1f} s ({time.perf_counter() - t0:.1f} s with load)")
    for line in cuda_build.load.log.read_text().splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("    ptxas:", line.strip())
    return card


def _main_path_clouds(dev):
    """Four voxel-filtered KITTI-proxy scans (kitti_config) on the card, the
    fourth also in the world frame, and a 262,144-capacity map filled with
    the first three in the world frame."""
    import torch

    from icpslam_tpu_torch.cloud import pointcloud as pc
    from icpslam_tpu_torch.cloud.voxel import voxel_downsample
    from icpslam_tpu_torch.config import kitti_config
    from icpslam_tpu_torch.geometry.se3 import Pose
    from icpslam_tpu_torch.io import synthetic

    cfg = kitti_config()
    world = synthetic.make_urban_world(seed=0)
    gt = synthetic.make_urban_drive(n_poses=4, rate_hz=10.0)
    clouds = []
    for (pts, mask), _ in synthetic.velodyne_stream(world, gt, capacity=cfg.max_raw_points):
        raw = pc.PointCloud(torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev))
        filt, _ = voxel_downsample(raw, cfg.voxel_leaf_size, cfg.max_points)
        clouds.append(filt)
    world_clouds = [
        pc.transform(
            Pose(t=torch.from_numpy(gt[0][i]).to(dev), q=torch.from_numpy(gt[1][i]).to(dev)), c
        )
        for i, c in enumerate(clouds)
    ]
    map_pts = torch.zeros((cfg.max_map_points, 3), device=dev)
    fill = 0
    for w in world_clouds[:3]:
        live = w.points[w.mask]
        map_pts[fill : fill + live.shape[0]] = live
        fill += live.shape[0]
    return clouds, world_clouds[3], map_pts, fill


def _grid_cloud(scan):
    """Adversarial inputs for the tile skip, from a voxel-filtered scan.

    The scan is rounded to a 0.25 m grid: with 8192 rows and |coordinates|
    < 128 m the query centroid and every centred coordinate are then exact
    in float32, so equal distances stay exactly equal. Returns
    ``(grid, with_p, p_row)``:
    - ``grid``: 40 low-index live points copied over live points in the
      last tiles, so a query there meets its duplicate in its own tile
      first and the lower index in a tile visited later; with the rounding's
      own coincident points, the k-lists hold exact ties too;
    - ``with_p``: ``grid`` as queries with row ``p_row`` replaced by a point
      P 50 m above the cloud whose only neighbours are A (index live − 2,
      in the last tile) and B (index 5, the largest x of the first 256
      rows, so of tile 0), both at exactly 0.5 m. Tile 0's bounding box
      lies at exactly that distance from P, and P's warp reaches A's tile
      first, so only an inclusive skip test keeps tile 0 and gives B, the
      lower index.
    """
    import torch

    pts, mask = scan.points, scan.mask
    live = int(mask.sum())
    if not (bool(mask[:live].all()) and live > 512 and float(pts.abs().max()) < 100):
        raise AssertionError("grid cloud: expected a live prefix of > 512 points within 100 m")
    grid = torch.round(pts * 4) / 4
    src = torch.arange(40, device=pts.device) * 97 + 7
    dst = live - 5 - 7 * torch.arange(40, device=pts.device)
    grid[dst] = grid[src]
    x0 = float(grid[:256, 0].max()) + 1.0
    y0 = float(grid[0, 1])
    z0 = float(grid[:live, 2].max()) + 50.0
    grid[5] = torch.tensor([x0 - 0.5, y0, z0], device=pts.device)
    grid[live - 2] = torch.tensor([x0 + 0.5, y0, z0], device=pts.device)
    p_row = 4000
    with_p = grid.clone()
    with_p[p_row] = torch.tensor([x0, y0, z0], device=pts.device)
    return grid.contiguous(), with_p.contiguous(), p_row


def phase_k1(clouds, query_world, map_pts, fill, dev):
    import torch

    from icpslam_tpu_torch.ops import nn

    q, t = clouds[1], clouds[0]
    vl_scan = t.mask.sum(dtype=torch.int32)
    live = int(vl_scan)
    map_mask = torch.arange(map_pts.shape[0], device=dev) < fill
    vl_map = torch.tensor(fill, dtype=torch.int32, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(0)
    rand_mask = (torch.rand(t.points.shape[0], generator=gen) < 0.7).to(dev) & t.mask
    far = torch.tensor([1000.0, -1000.0, 1000.0], device=dev)
    grid, with_p, p_row = _grid_cloud(t)
    far_q = q.points.clone()
    far_q[3000] = torch.tensor([500.0, -400.0, 300.0], device=dev)
    cases = {
        "scan 8192x8192": (q.points, t.points, t.mask, vl_scan),
        "map 8192x262144": (query_world.points, map_pts, map_mask, vl_map),
        "masked 70%": (q.points, t.points, rand_mask, None),
        "all masked": (q.points, t.points, torch.zeros_like(t.mask), None),
        "1 km from origin": (q.points + far, t.points + far, t.mask, vl_scan),
        "duplicates across tiles": (grid, grid, t.mask, vl_scan),
        "target at the AABB bound": (with_p, grid, t.mask, vl_scan),
        "valid_len mid-tile": (q.points, t.points, torch.ones_like(t.mask),
                               torch.tensor(5037, dtype=torch.int32, device=dev)),
        "one query 700 m away": (far_q, t.points, t.mask, None),
        "ragged 7997x7001": (q.points[:7997], t.points[:7001], t.mask[:7001], None),
    }
    err = 0.0
    for name, (qq, tt, mm, vl) in cases.items():
        qq, tt = qq.contiguous(), tt.contiguous()
        k = nn.nn1_cuda(qq, tt, mm, vl)
        p = nn.nearest_neighbors_plain(qq, tt, mm, vl)
        torch.cuda.synchronize()
        err = max(err, _equal(f"nn1 {name}", k.idx, k.dist2, p.idx, p.dist2))
        if name == "all masked" and not (torch.isinf(k.dist2).all() and (k.idx == 0).all()):
            raise AssertionError("nn1 all masked: expected inf / index 0")
        if name == "target at the AABB bound":
            # B (index 5) and A (index live - 2) tie at exactly 0.25 m², and
            # tile 0's box lies exactly that far from P
            c = qq.mean(0)
            pc, tc = qq[p_row] - c, tt - c
            d_a = float(nn._sqdist(tc[live - 2] - pc))
            lo, hi = tc[:256].amin(0), tc[:256].amax(0)
            gap = torch.clamp(torch.maximum(lo - pc, pc - hi), min=0.0)
            lb2 = float(nn._sqdist(gap))
            if not (int(p.idx[p_row]) == 5 and float(p.dist2[p_row]) == 0.25 == d_a == lb2):
                raise AssertionError(f"nn1 AABB bound: not the tie at the bound ({int(p.idx[p_row])}, "
                                     f"{float(p.dist2[p_row])}, {d_a}, {lb2})")
        if name == "duplicates across tiles" and not (
            int(k.idx[live - 5]) <= 7 and float(k.dist2[live - 5]) == 0.0
        ):
            raise AssertionError("nn1 duplicates: the lower index did not win")
    out = {}
    for name, n_live in (("scan 8192x8192", live), ("map 8192x262144", fill)):
        qq, tt, mm, vl = cases[name]
        qq, tt = qq.contiguous(), tt.contiguous()
        n = qq.shape[0]
        pairs = _pairs(lambda pr: nn.nn1_cuda(qq, tt, mm, vl, pairs=pr))
        bound = _nn_bound(n, n_live, pairs, 8)
        bound_all = _nn_bound(n, tt.shape[0], n * n_live, 8)
        out[name] = {
            "ms": _device_ms(lambda: nn.nn1_cuda(qq, tt, mm, vl)),
            "plain_ms": _timed(lambda: nn.nearest_neighbors_plain(qq, tt, mm, vl), iters=20),
            "pairs_share": pairs / (n * n_live),
            "bound_ms": bound[0], "bound_by": bound[1],
            "bound_all_pairs_ms": bound_all[0],
        }
        r = out[name]
        print(f"[2] nn1 {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms; pairs "
              f"evaluated {100 * r['pairs_share']:.2f}%; bound {bound[0]:.5f} ms ({bound[1]}), "
              f"all pairs {bound_all[0]:.4f} ms")
    print(f"[2] nn1 equals its plain version (d2 bits, indices) on {len(cases)} cases; "
          f"max |d2 err| {err:.3g}")
    return err, out


def phase_k2(clouds, dev):
    import torch

    from icpslam_tpu_torch.ops import nn

    c, other = clouds[0], clouds[1]
    pts, mask = c.points.contiguous(), c.mask
    grid, with_p, p_row = _grid_cloud(c)
    few = torch.zeros_like(mask)
    few[:5] = True
    far_q = other.points.clone()
    far_q[3000] = torch.tensor([500.0, -400.0, 300.0], device=dev)
    cases = {
        "self k=10": (pts, pts, mask, 10),
        "self k=16": (pts, pts, mask, 16),
        "duplicates in the k-list": (grid, grid, mask, 10),
        "5 live, k=10": (pts, pts, few, 10),
        "all masked": (pts, pts, torch.zeros_like(mask), 10),
        "one query 700 m away": (far_q.contiguous(), pts, mask, 10),
        "ragged 7997x7001": (other.points[:7997].contiguous(), pts[:7001].contiguous(),
                             mask[:7001], 10),
        "AABB bound, k=1": (with_p, grid, mask, 1),
    }
    err = 0.0
    for name, (qq, tt, mm, k) in cases.items():
        idx_k, d_k = nn.knn_cuda(qq, tt, mm, k)
        idx_p, d_p = nn.knn_plain(qq, tt, mm, k)
        torch.cuda.synchronize()
        err = max(err, _equal(f"knn {name}", idx_k, d_k, idx_p, d_p))
        if name == "self k=10":
            live = mm.nonzero(as_tuple=True)[0]
            if not (torch.equal(idx_k[live, 0], live) and (d_k[live, 0] == 0).all()):
                raise AssertionError("knn: a live self-query must find itself first at d2 = 0")
        if name == "5 live, k=10" and not (torch.isinf(d_k[:, 5:]).all() and (idx_k[:, 5:] == 0).all()):
            raise AssertionError("knn: missing neighbours must be inf with index 0")
        if name == "duplicates in the k-list" and not int(((d_k[:, :-1] == d_k[:, 1:])
                                                          & torch.isfinite(d_k[:, 1:])).sum()):
            raise AssertionError("knn duplicates: no exact tie inside a k-list")
        if name == "AABB bound, k=1" and int(idx_p[p_row, 0]) != 5:
            raise AssertionError("knn AABB bound: the case is not the tie at index 5")
    k = 10
    n, live = pts.shape[0], int(mask.sum())
    pairs = _pairs(lambda pr: nn.knn_cuda(pts, pts, mask, k, pairs=pr))
    bound = _nn_bound(n, n, pairs, 8 * k)
    bound_all = _nn_bound(n, n, n * live, 8 * k)
    res = {
        "ms": _device_ms(lambda: nn.knn_cuda(pts, pts, mask, k)),
        "plain_ms": _timed(lambda: nn.knn_plain(pts, pts, mask, k), iters=20),
        "pairs_share": pairs / (n * live),
        "bound_ms": bound[0], "bound_by": bound[1], "bound_all_pairs_ms": bound_all[0],
    }
    print(f"[3] knn self 8192 k=10: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms; "
          f"pairs evaluated {100 * res['pairs_share']:.2f}%; bound {bound[0]:.5f} ms "
          f"({bound[1]}), all pairs {bound_all[0]:.4f} ms; "
          f"equals its plain version on {len(cases)} cases; max |d2 err| {err:.3g}")
    return err, res


def _drive(source, cfg, poses, dev, rendered=None, backend=None, prefetch_depth=3, mesh=None):
    """Run the port's runner loop with every kernel's launch count set to 0
    just before it; the counts are read just after. K1's calls are also
    split by target capacity: ``nn1_scan`` (a scan or keyframe cloud,
    ``max_points``) and ``nn1_map`` (the map, ``max_map_points``).
    ``rendered``: ``(scans, gt)`` rendered beforehand instead of
    ``source``'s stream; ``backend``: a deferred back end, called after
    every step and flushed at the end; ``prefetch_depth``: the runner's
    scans prepared and uploaded ahead (0: inline); ``mesh``: the mesh of
    the sharded map and the dist-* solvers."""
    import torch

    from icpslam_tpu_torch.geometry.se3 import Pose
    from icpslam_tpu_torch.io import runner
    from icpslam_tpu_torch.ops import nn

    stream, gt = rendered if rendered is not None else source(cfg, poses, 10.0)
    init = Pose(t=torch.from_numpy(gt[0][0]).to(dev), q=torch.from_numpy(gt[1][0]).to(dev))
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in runner.KERNELS.values():
        fn.launches = 0
    nn.nn1_cuda.launches_by_capacity.clear()
    post = backend.maybe_launch_or_fold if backend is not None else None
    res = runner.run_slam(stream, cfg, init, dev, post_step=post, prefetch_depth=prefetch_depth,
                          mesh=mesh)
    if backend is not None:
        res.state = backend.flush(res.state)
    launches = {name: fn.launches for name, fn in runner.KERNELS.items()}
    by_m = nn.nn1_cuda.launches_by_capacity
    launches["nn1_scan"] = by_m.get(cfg.max_points, 0)
    launches["nn1_map"] = by_m.get(cfg.max_map_points, 0)
    if launches["nn1_scan"] + launches["nn1_map"] != launches["nn1"]:
        raise AssertionError(f"K1 calls on other target capacities: {by_m}")
    peak = torch.cuda.max_memory_allocated(dev)
    summary = {**res.summary(), **runner.evaluate(res, gt)}
    if not torch.isfinite(torch.from_numpy(res.records[:, :7])).all():
        raise AssertionError("non-finite poses in the trajectory")
    if res.records.shape != (poses, 18):
        raise AssertionError(f"records shape {res.records.shape}")
    return summary, launches, peak, res


def phase_sentinel(dev):
    from icpslam_tpu_torch.io import runner

    s, launches, _, _ = _drive(runner.synthetic_source, runner.synthetic_config(), 20, dev)
    print(f"[4] room-loop sentinel: ATE {s['ate_m']:.4f} m, {s['loop_closures']} loop-closure "
          f"edges, {s['optimizations']} optimizations, launches {launches}")
    if not s["ate_m"] <= 0.02:
        raise AssertionError(f"sentinel ATE {s['ate_m']} > 0.02 m")
    if s["loop_closures"] < 7:
        raise AssertionError(f"sentinel: {s['loop_closures']} loop-closure edges < 7")
    if not (launches["nn1"] > 0 and launches["knn"] > 0):
        raise AssertionError(f"sentinel did not run through both kernels: {launches}")
    return s


def phase_slice(dev):
    import numpy as np

    from icpslam_tpu_torch.config import kitti_config
    from icpslam_tpu_torch.io import runner

    n = SLICE_SCANS
    s, launches, peak, res = _drive(runner.kitti_proxy_source, kitti_config(), n, dev)
    # the same drive with the render and the upload inline (prefetch depth
    # 0): the source renders on the fly, so at depth 3 the render runs on
    # the prefetch thread beside the steps
    s0, _, _, res0 = _drive(runner.kitti_proxy_source, kitti_config(), n, dev, prefetch_depth=0)
    print(f"[5] prefetch depth 3: ms/scan median {s['step_ms_p50']:.2f}, wall {s['wall_time_s']:.2f} s; "
          f"depth 0 (render and upload inline): median {s0['step_ms_p50']:.2f}, wall "
          f"{s0['wall_time_s']:.2f} s; records equal: {np.array_equal(res.records, res0.records)}")
    print(f"[5] kitti_config slice, {n} scans: ATE {s['ate_m']:.4f} m, accepted "
          f"{s['accepted']}/{n}, {s['optimizations']} optimizations, {s['keyframes']} keyframes")
    print(f"[5] ms/scan median {s['step_ms_p50']:.2f} p90 {s['step_ms_p90']:.2f} "
          f"(first scan {s['compile_ms']:.1f}); host syncs/scan {s['host_syncs_per_scan']:.2f}; "
          f"K1 launches/scan {launches['nn1'] / n:.2f} (scan target "
          f"{launches['nn1_scan'] / n:.2f}, map {launches['nn1_map'] / n:.2f}), "
          f"K2 {launches['knn'] / n:.2f}; "
          f"peak memory {peak / 2**20:.1f} MiB")
    if s["accepted"] < 0.9 * n:
        raise AssertionError(f"only {s['accepted']}/{n} scans accepted")
    if s["optimizations"] < 1:
        raise AssertionError("no graph optimization ran")
    if not s["ate_m"] <= 0.10:
        raise AssertionError(f"slice ATE {s['ate_m']} > 0.10 m")
    if not (launches["nn1"] > 0 and launches["knn"] > 0):
        raise AssertionError(f"slice did not run through both kernels: {launches}")
    return {**s, "peak_bytes": peak, "depth0": s0}, launches, res.records


def _near_boundary(q, t, m, r):
    """Queries with a live target whose float64 d² lies within BOUNDARY·r² of r²."""
    import torch

    q64, t64 = q.double(), t.double()
    rows = []
    for s in range(0, q.shape[0], 1024):
        d2 = ((t64[None, :, :] - q64[s : s + 1024, None, :]) ** 2).sum(-1)
        rows.append((((d2 - r * r).abs() < BOUNDARY * r * r) & m[None, :]).any(1))
    return torch.cat(rows)


def _close(name, a, b) -> float:
    """|a − b| ≤ MOM_ABS + MOM_REL·|b| elementwise; returns the max |a − b|."""
    diff = (a - b).abs()
    bad = diff > MOM_ABS + MOM_REL * b.abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} entries differ, max {float(diff.max())}")
    return float(diff.max()) if diff.numel() else 0.0


def _radius_boundary(grid, live, r):
    """The K3 cases at the radius, on ``_grid_cloud``'s grid: queries =
    ``grid`` with row ``p_row`` replaced by P, 50 m above the cloud. B (row
    5, tile 0) lies exactly r below P, so d² == r² (out of radius) and tile
    0's box lies exactly r from P, which an inclusive skip test sweeps; A
    (row live − 2, the last tile) lies r − r/256 below P, at the top of its
    tile's box, so the box distance equals its d² < r². Returns ``(q, t,
    p_row)``."""
    import torch

    t = grid.clone()
    px, py = float(t[3000, 0]), float(t[3000, 1])
    pz = float(t[:live, 2].max()) + 50.0
    t[5] = torch.tensor([px, py, pz - r], device=t.device)
    t[live - 2] = torch.tensor([px, py, pz - (r - r / 256)], device=t.device)
    p_row = 4001
    q = t.clone()
    q[p_row] = torch.tensor([px, py, pz], device=t.device)
    return q.contiguous(), t.contiguous(), p_row


def phase_k3(clouds, dev):
    import torch

    from icpslam_tpu_torch.ops import radius_stats as rs

    c, other = clouds[0], clouds[1]
    pts, mask = c.points.contiguous(), c.mask
    live = int(mask.sum())
    gen = torch.Generator(device="cpu").manual_seed(1)
    keep30 = (torch.rand(pts.shape[0], generator=gen) >= 0.7).to(dev) & mask
    far = torch.tensor([1000.0, -1000.0, 1000.0], device=dev)
    r, sigma = 1.0, 0.5
    grid, _, _ = _grid_cloud(c)
    bq, bt, p_row = _radius_boundary(grid, live, r)
    far_q = pts.clone()
    far_q[3000] = torch.tensor([500.0, -400.0, 300.0], device=dev)
    ragged = (other.points[:7997].contiguous(), pts[:7001].contiguous(), mask[:7001])
    cases = {
        "hard": (pts, pts, mask, 0.0),
        "taper": (pts, pts, mask, sigma),
        "hard, 70% masked": (pts, pts, keep30, 0.0),
        "taper, 70% masked": (pts, pts, keep30, sigma),
        "all masked": (pts, pts, torch.zeros_like(mask), sigma),
        "hard, 1 km from origin": ((pts + far).contiguous(), (pts + far).contiguous(), mask, 0.0),
        "taper, 1 km from origin": ((pts + far).contiguous(), (pts + far).contiguous(), mask, sigma),
        "hard, duplicates across tiles": (grid, grid, mask, 0.0),
        "hard, d2 == r2 and the box edge": (bq, bt, mask, 0.0),
        "taper, d2 == r2 and the box edge": (bq, bt, mask, sigma),
        "hard, ragged 7997x7001": (*ragged, 0.0),
        "taper, ragged 7997x7001": (*ragged, sigma),
        "hard, one query 700 m away": (far_q, pts, mask, 0.0),
    }
    err, inside, boundary_rows = 0.0, 0, 0
    for name, (q, t, m, sg) in cases.items():
        pairs = torch.zeros(1, dtype=torch.int64, device=dev)
        k = rs.radius_moments_cuda(q, t, m, r, sg, pairs=pairs)
        pl = rs.radius_moments_plain(q, t, m, r, sg)
        torch.cuda.synchronize()
        if sg == 0.0 and not torch.equal(k[0], pl[0]):
            bad = k[0] != pl[0]
            raise AssertionError(f"radius {name}: counts differ on {int(bad.sum())} rows")
        err = max(err, _close(f"radius {name} count", k[0], pl[0]))
        err = max(err, _close(f"radius {name} mean", k[1], pl[1]))
        err = max(err, _close(f"radius {name} cov", k[2], pl[2]))
        want = rs.swept_pairs_plain(q, t, m, r)
        if int(pairs) != want:
            raise AssertionError(f"radius {name}: the pair counter says {int(pairs)}, "
                                 f"swept_pairs_plain {want}")
        boundary_rows += int(_near_boundary(q, t, m, r).sum())
        if name == "hard":
            inside = int(pl[0].sum())
        if name == "all masked" and any(bool(x.any()) for x in k):
            raise AssertionError("radius all masked: expected zeros")
        if name.startswith("hard, d2 == r2") and not (
            float(k[0][p_row]) == 1.0 and torch.equal(k[1][p_row], bt[live - 2])
        ):
            raise AssertionError("radius boundary: P must count A (at the box edge) and not B "
                                 "(at d2 == r2)")
        if name == "hard, one query 700 m away" and float(k[0][3000]) != 0.0:
            raise AssertionError("radius: the far query found a neighbour")
    if boundary_rows < 1:
        raise AssertionError("radius: no case has a row at the radius")
    n = pts.shape[0]
    # 8 operations per swept (query, live target) pair for d², then for
    # each pair in radius one expf (counted as one operation) and 19 for the
    # weighted sums; ~30 per query for the epilogue; bytes: the queries and
    # targets, the mask and the 13 outputs per query
    nbytes = 12 * n + 12 * n + n + 52 * n
    bound_all = _bound(8.0 * n * live + 20.0 * inside + 30.0 * n, nbytes)
    swept = _pairs(lambda pr: rs.radius_moments_cuda(pts, pts, mask, r, sigma, pairs=pr))
    if swept != rs.swept_pairs_plain(pts, pts, mask, r):
        raise AssertionError(f"radius timed case: the pair counter says {swept}, "
                             f"swept_pairs_plain {rs.swept_pairs_plain(pts, pts, mask, r)}")
    bound = _bound(8.0 * swept + 20.0 * inside + 30.0 * n, nbytes)
    out = {
        "ms": _device_ms(lambda: rs.radius_moments_cuda(pts, pts, mask, r, sigma)),
        "hard_ms": _device_ms(lambda: rs.radius_moments_cuda(pts, pts, mask, r, 0.0)),
        "pairs_share": swept / (n * live),
        "bound_ms": bound[0], "bound_by": bound[1], "bound_all_pairs_ms": bound_all[0],
        "plain_ms": _timed(lambda: rs.radius_moments_plain(pts, pts, mask, r, sigma), iters=10),
    }
    print(f"[6] radius_moments self 8192, r {r}: kernel {out['ms']:.4f} ms (sigma {sigma}), "
          f"{out['hard_ms']:.4f} ms (hard); pairs swept {100 * out['pairs_share']:.2f}% "
          f"(kernel counter); bound {bound[0]:.5f} ms ({bound[1]}), all pairs "
          f"{bound_all[0]:.4f} ms")
    print(f"[6] radius_moments plain {out['plain_ms']:.4f} ms; {inside} pairs in radius; equals "
          f"its plain version on {len(cases)} cases (hard counts on every row, {boundary_rows} "
          f"rows at the radius among them; pair counter = swept_pairs_plain), max err {err:.3g}")
    return err, out


def phase_k4(clouds, query_world, map_pts, fill, dev):
    import torch

    from icpslam_tpu_torch.ops import nn
    from icpslam_tpu_torch.ops.nn import _sqdist

    q, t = clouds[1], clouds[0]
    map_mask = torch.arange(map_pts.shape[0], device=dev) < fill
    cases = {
        "scan 8192x8192": (q.points, t.points, t.mask, t.mask.sum(dtype=torch.int32)),
        "map 8192x262144": (query_world.points, map_pts, map_mask,
                            torch.tensor(fill, dtype=torch.int32, device=dev)),
        "ragged 7997x7001": (q.points[:7997], t.points[:7001], t.mask[:7001], None),
        "valid_len mid-tile": (q.points, t.points, torch.ones_like(t.mask),
                               torch.tensor(5037, dtype=torch.int32, device=dev)),
    }
    err, times = 0.0, {}
    for name, (qq, tt, mm, vl) in cases.items():
        qq, tt = qq.contiguous(), tt.contiguous()
        k = nn.nn1_matmul_cuda(qq, tt, mm, vl)
        p = nn.nearest_neighbors_matmul_plain(qq, tt, mm, vl)
        k1 = nn.nn1_cuda(qq, tt, mm, vl)
        torch.cuda.synchronize()
        center = qq.mean(0)
        qc, tc = qq - center, tt - center
        qc2, tc2 = _sqdist(qc), _sqdist(tc)
        tol = K4_REL * (qc2 + torch.maximum(tc2[k.idx], tc2[p.idx])) + K4_ABS
        fin = torch.isfinite(p.dist2)
        if not torch.equal(fin, torch.isfinite(k.dist2)):
            raise AssertionError(f"nn1_matmul {name}: inf pattern differs")
        diff = (k.dist2 - p.dist2).abs()[fin]
        if (diff > tol[fin]).any():
            raise AssertionError(f"nn1_matmul {name}: d2 off by up to {float(diff.max())}")
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
        sub_k = _sqdist(tc[k.idx] - qc)
        sub_p = _sqdist(tc[p.idx] - qc)
        differ = (k.idx != p.idx) & fin
        if ((sub_k - sub_p).abs() > tol)[differ].any():
            raise AssertionError(f"nn1_matmul {name}: indices differ beyond the rounding")
        if ((sub_k - k1.dist2).abs() > tol)[fin].any():
            raise AssertionError(f"nn1_matmul {name}: its pick is not K1's within the rounding")
        live = int(mm.sum()) if vl is None else int(mm[: int(vl)].sum())
        if vl is not None and not bool((k.idx[fin] < int(vl)).all()):
            raise AssertionError(f"nn1_matmul {name}: a pick at or past valid_len")
        print(f"[7] nn1_matmul {name}: {int(differ.sum())} picks differ from the plain version")
        if name not in ("scan 8192x8192", "map 8192x262144"):
            continue
        n = qq.shape[0]
        bound = _nn_bound(n, live, n * live, 8)
        times[name] = {
            "ms": _device_ms(lambda: nn.nn1_matmul_cuda(qq, tt, mm, vl)),
            "plain_ms": _timed(lambda: nn.nearest_neighbors_matmul_plain(qq, tt, mm, vl), iters=20),
            "nn1_ms": _device_ms(lambda: nn.nn1_cuda(qq, tt, mm, vl)),
            "bound_ms": bound[0], "bound_by": bound[1],
        }
        x = times[name]
        print(f"[7] nn1_matmul {name}: kernel {x['ms']:.4f} ms, plain {x['plain_ms']:.4f} ms, "
              f"K1 in the same call {x['nn1_ms']:.4f} ms; bound {bound[0]:.5f} ms ({bound[1]})")
    print(f"[7] nn1_matmul matches its plain version and K1 within the rounding on {len(cases)} "
          f"cases, max |d2 err| {err:.3g}")
    return err, times


def radius_config():
    """``kitti_config()`` with radius covariances in both ICP stages: r =
    1.0 m (2.5 leaves of the 0.4 m voxel) and a Gaussian taper σ = r/2.
    Both stages share them, so scan-to-map reuses the odometry's."""
    from icpslam_tpu_torch.config import IcpConfig, kitti_config

    radius = dict(covariance_mode="radius", covariance_radius=1.0, covariance_sigma=0.5)
    return kitti_config(
        icp_odometry=IcpConfig(mode="plane", max_iterations=10, max_correspondence_distance=2.0,
                               huber_delta=1.0, **radius),
        icp_mapping=IcpConfig(mode="plane", max_iterations=30, max_correspondence_distance=2.0,
                              huber_delta=1.0, **radius),
    )


def phase_mission(dev):
    import numpy as np

    from icpslam_tpu_torch.io import runner

    n = MISSION_SCANS
    rendered = _render_idealized(radius_config(), n)
    s, launches, peak, res = _drive(runner.kitti_proxy_source, radius_config(), n, dev,
                                    rendered=rendered)
    per = {k: v / n for k, v in launches.items()}
    print(f"[8] radius mission, {n} scans: ATE {s['ate_m']:.4f} m, accepted {s['accepted']}/{n}, "
          f"{s['keyframes']} keyframes, {s['loop_closures']} loop-closure edges, "
          f"{s['window_solves']} window and {s['full_solves']} full solves")
    print(f"[8] ms/scan median {s['step_ms_p50']:.2f} p90 {s['step_ms_p90']:.2f} "
          f"(first scan {s['compile_ms']:.1f}); host syncs/scan {s['host_syncs_per_scan']:.2f}; "
          f"launches/scan K1 {per['nn1']:.2f} (scan target {per['nn1_scan']:.2f}, map "
          f"{per['nn1_map']:.2f}), K2 {per['knn']:.2f}, K3 {per['radius']:.2f}, "
          f"K4 {per['nn1_matmul']:.2f}; peak memory {peak / 2**20:.1f} MiB")
    rec = res.records
    loops = np.nonzero(rec[:, 13] > 0)[0]
    full = (rec[:, 14] > 0) & (np.asarray(res.window_solves) == 0)
    if s["accepted"] < 0.9 * n:
        raise AssertionError(f"only {s['accepted']}/{n} scans accepted")
    if not s["ate_m"] <= MISSION_ATE:
        raise AssertionError(f"mission ATE {s['ate_m']} > {MISSION_ATE} m")
    if s["loop_closures"] < 1 or not loops.size:
        raise AssertionError("no loop-closure edge")
    if s["window_solves"] < 1:
        raise AssertionError("no window solve ran")
    if not full[loops[0]:].any():
        raise AssertionError("no full solve after a loop closure")
    if launches["radius"] < s["processed"] or launches["radius"] < 1:
        raise AssertionError(f"K3 launched {launches['radius']} times for {s['processed']} "
                             "processed scans")
    if launches["knn"] != 0 or launches["nn1"] < 1:
        raise AssertionError(f"radius mode must bypass K2 and run K1: {launches}")
    return {**s, "peak_bytes": peak, "first_loop_scan": int(loops[0])}, launches


def _segments(step_ms, first_pcg: int, first_eviction: int) -> dict:
    """Median and p90 ms/scan before the first PCG solve (the first scan
    left out, as in the runner's summary), from it to the first eviction,
    and after."""
    import numpy as np

    cuts = {"before_pcg": (1, min(first_pcg, first_eviction)),
            "pcg_to_eviction": (first_pcg, max(first_pcg, first_eviction)),
            "after_eviction": (first_eviction, len(step_ms))}
    out = {}
    for name, (a, b) in cuts.items():
        x = np.asarray(step_ms[a:b])
        out[name] = {"scans": int(x.size),
                     "p50": float(np.median(x)) if x.size else None,
                     "p90": float(np.percentile(x, 90)) if x.size else None}
    return out


def _ms_stats(step_ms, scans=None) -> dict:
    """Median, p90, p99 and max of the step times of ``scans`` (all of them
    by default), the first scan of the run left out as in the runner's
    summary."""
    import numpy as np

    idx = np.arange(1, len(step_ms)) if scans is None else np.asarray(
        [i for i in scans if i > 0], dtype=int)
    x = np.asarray(step_ms)[idx] if idx.size else np.zeros(0)
    if not x.size:
        return {"scans": 0}
    return {"scans": int(x.size), "p50": float(np.median(x)), "p90": float(np.percentile(x, 90)),
            "p99": float(np.percentile(x, 99)), "max": float(x.max())}


def _fmt(m: dict) -> str:
    if not m.get("scans"):
        return "no scans"
    return (f"median {m['p50']:.2f} p90 {m['p90']:.2f} p99 {m['p99']:.2f} max {m['max']:.2f} "
            f"({m['scans']} scans)")


def _ate(res, m: int) -> float:
    """ATE (m, SE(3)-aligned) of the first ``m`` scans of a run of the
    KITTI proxy."""
    import torch

    from icpslam_tpu_torch.eval import metrics
    from icpslam_tpu_torch.geometry.se3 import Pose
    from icpslam_tpu_torch.io import synthetic

    gt = synthetic.make_urban_drive(n_poses=res.records.shape[0], rate_hz=10.0)
    rec = torch.from_numpy(res.records[:m])
    ate, _ = metrics.ate(Pose(rec[:, :3], rec[:, 3:7]),
                         Pose(torch.from_numpy(gt[0][:m]), torch.from_numpy(gt[1][:m])), align=True)
    return float(ate)


def _render(source, cfg, n):
    """``source``'s stream, rendered on the host into a list: ``(scans, gt)``."""
    t0 = time.perf_counter()
    stream, gt = source(cfg, n, 10.0)
    scans = list(stream)
    print(f"    rendered {n} scans in {time.perf_counter() - t0:.1f} s")
    return scans, gt


def _render_slice(job):
    """Scans ``[a, b)`` of the idealized urban proxy of ``n`` poses
    (``runner.kitti_proxy_source`` without physics): scan i is rendered
    from its pose with seed i alone, so a slice of the trajectory rendered
    with seed ``a`` gives the same scans."""
    from icpslam_tpu_torch.io import synthetic

    capacity, n, a, b = job
    world = synthetic.make_urban_world(seed=0)
    t, q = synthetic.make_urban_drive(n_poses=n, rate_hz=10.0)
    stream = synthetic.velodyne_stream(world, (t[a:b], q[a:b]), capacity, rate_hz=10.0, seed=a)
    return [(pm, (a + j) / 10.0) for j, (pm, _) in enumerate(stream)]


def _render_idealized(cfg, n):
    """``_render(runner.kitti_proxy_source, cfg, n)`` in RENDER_WORKERS
    processes; the first scan is held to the runner's stream and a slice
    boundary to a slice that straddles it, bit for bit."""
    import multiprocessing

    import numpy as np

    from icpslam_tpu_torch.io import runner

    t0 = time.perf_counter()
    stream, gt = runner.kitti_proxy_source(cfg, n, 10.0)
    per = -(-n // RENDER_WORKERS)
    jobs = [(cfg.max_raw_points, n, a, min(a + per, n)) for a in range(0, n, per)]
    with multiprocessing.get_context("spawn").Pool(len(jobs)) as pool:
        scans = [s for part in pool.map(_render_slice, jobs) for s in part]
    checks = [(next(iter(stream)), scans[0])]
    if n > per:
        checks.append((_render_slice((cfg.max_raw_points, n, per - 1, per + 1))[1], scans[per]))
    for ((p0, m0), s0), ((p1, m1), s1) in checks:
        if not (np.array_equal(p0, p1) and np.array_equal(m0, m1) and s0 == s1):
            raise AssertionError("the parallel render differs from the runner's stream")
    print(f"    rendered {n} scans in {time.perf_counter() - t0:.1f} s ({len(jobs)} processes)")
    return scans, gt


def phase_long_mission(dev, rendered, cfg=None):
    """The long mission (phase 9) on ``rendered`` scans. Returns its
    summary, launch counts and the runner's result."""
    import numpy as np
    import torch

    from icpslam_tpu_torch.config import kitti_config
    from icpslam_tpu_torch.io import runner

    cfg = cfg or kitti_config()
    n = len(rendered[0])
    s, launches, peak, res = _drive(runner.kitti_proxy_source, cfg, n, dev, rendered=rendered)
    rec = res.records
    cap = cfg.max_keyframes
    new_kf = rec[:, 12] > 0
    kf_before = np.concatenate([[0.0], rec[:-1, 16]])
    evict_scans = np.nonzero(new_kf & (kf_before >= cap))[0]
    pcg_scans = np.nonzero(np.asarray(res.pcg_solves) > 0)[0]
    first_pcg = int(pcg_scans[0]) if pcg_scans.size else n
    first_ev = int(evict_scans[0]) if evict_scans.size else n
    seg = _segments(res.step_ms, first_pcg, first_ev)
    ate_before_pcg = _ate(res, first_pcg)
    edges = res.state.edges
    count = int(edges.count)
    valid = edges.valid.cpu()
    prefix = bool(valid[:count].all()) and not bool(valid[count:].any())
    loops_after = int(rec[first_ev:, 13].sum())
    print(f"[9] long mission, {n} scans: ATE {s['ate_m']:.4f} m ({ate_before_pcg:.4f} m over the "
          f"{first_pcg} scans before the first PCG solve), accepted {s['accepted']}/{n}, "
          f"{s['keyframes']} keyframes, {s['keyframe_evictions']} evictions (first at scan {first_ev}), "
          f"{s['edges']} edges, {s['loop_closures']} loop-closure edges ({loops_after} after the "
          f"first eviction), {s['pcg_solves']} PCG solves (first at scan {first_pcg}), "
          f"{s['window_solves']} window and {s['full_solves']} full solves")
    for name, x in seg.items():
        if x["scans"]:
            print(f"[9] ms/scan {name} ({x['scans']} scans): median {x['p50']:.2f} p90 {x['p90']:.2f}")
    per = {k: v / n for k, v in launches.items()}
    print(f"[9] host syncs/scan {s['host_syncs_per_scan']:.2f}; edge overflow {s['edge_overflow']}; "
          f"launches/scan K1 {per['nn1']:.2f} (scan target {per['nn1_scan']:.2f}, map "
          f"{per['nn1_map']:.2f}), K2 {per['knn']:.2f}, K3 {per['radius']:.2f}, "
          f"K4 {per['nn1_matmul']:.2f}; peak memory {peak / 2**20:.1f} MiB")
    if s["accepted"] < 0.9 * n:
        raise AssertionError(f"only {s['accepted']}/{n} scans accepted")
    if not s["ate_m"] <= LONG_ATE:
        raise AssertionError(f"long mission ATE {s['ate_m']} > {LONG_ATE} m")
    if s["keyframes"] != cap or s["keyframe_evictions"] < 20 or s["keyframe_evictions"] != evict_scans.size:
        raise AssertionError(f"expected a full store of {cap} and >= 20 evictions, got "
                             f"{s['keyframes']} keyframes, {s['keyframe_evictions']} evictions "
                             f"({evict_scans.size} eviction scans)")
    if s["pcg_solves"] < 3 or s["window_solves"] < 1:
        raise AssertionError(f"{s['pcg_solves']} PCG and {s['window_solves']} window solves")
    if loops_after < 1:
        raise AssertionError("no loop-closure edge after the first eviction")
    if not prefix:
        raise AssertionError(f"the edge store is not a valid prefix of {count}")
    if not (launches["nn1"] > 0 and launches["knn"] > 0
            and launches["radius"] == 0 and launches["nn1_matmul"] == 0):
        raise AssertionError(f"the long mission must run K1 and K2 and neither K3 nor K4: {launches}")
    if not torch.isfinite(res.state.keyframes.pose_graph.t).all():
        raise AssertionError("non-finite graph poses")
    out = {**s, "peak_bytes": peak, "first_pcg_scan": first_pcg, "first_eviction_scan": first_ev,
           "ate_before_first_pcg_m": ate_before_pcg,
           "loop_closures_after_first_eviction": loops_after, "segments": seg,
           "ms": _ms_stats(res.step_ms),
           "ms_optimize_scans": _ms_stats(res.step_ms, np.nonzero(rec[:, 14] > 0)[0])}
    return out, launches, res


def phase_solvers(state, chunk: int = 64, sep_capacity: int = 64):
    """The three linear solvers on the final graph of phase 9 (phase 10)."""
    import torch

    from icpslam_tpu_torch.graph import pose_graph as pg
    from icpslam_tpu_torch.graph import schur

    store, edges = state.keyframes, state.edges
    nodes, mask = store.pose_graph, store.valid_mask()
    K = store.capacity
    n_sep = int(schur.separator_mask(edges.i, edges.j, edges.valid, K, chunk).sum())
    out, poses = {}, {}
    for solver in ("direct", "pcg", "schur"):
        def solve():
            return pg.optimize(nodes, edges, mask, iterations=3, mode="lm", linear_solver=solver,
                               schur_chunk_size=chunk, schur_sep_capacity=sep_capacity)

        opt, stats = solve()
        poses[solver] = opt
        out[solver] = {"ms": _timed(solve, iters=5, warmup=1),
                       "initial_cost": float(stats.initial_cost),
                       "final_cost": float(stats.final_cost)}
    out["schur"].update(n_sep=n_sep, fell_back=n_sep > sep_capacity)
    for solver in ("pcg", "schur"):
        d = torch.linalg.norm(poses[solver].t - poses["direct"].t, dim=-1)
        out[solver]["max_dist_to_direct_m"] = float(d.max())
    for solver, x in out.items():
        extra = (f"; {x['max_dist_to_direct_m']:.3g} m from direct" if solver != "direct" else "")
        extra += (f"; {n_sep} separators for {sep_capacity} slots, "
                  f"{'fell back to direct' if x.get('fell_back') else 'no fallback'}"
                  if solver == "schur" else "")
        print(f"[10] {solver} on {int(store.count)} nodes, {int(edges.count)} edges: "
              f"{x['ms']:.2f} ms, cost {x['initial_cost']:.6g} -> {x['final_cost']:.6g}{extra}")
    for solver, opt in poses.items():
        if not (torch.isfinite(opt.t).all() and torch.isfinite(opt.q).all()):
            raise AssertionError(f"{solver}: non-finite poses")
        if not out[solver]["final_cost"] <= out[solver]["initial_cost"]:
            raise AssertionError(f"{solver}: the cost rose")
        if solver != "direct" and not out[solver]["max_dist_to_direct_m"] <= SOLVER_DIST:
            raise AssertionError(f"{solver}: poses {out[solver]['max_dist_to_direct_m']} m from "
                                 f"the direct solve's (> {SOLVER_DIST})")
    out.update(nodes=int(store.count), edges=int(edges.count), chunk=chunk,
               sep_capacity=sep_capacity)
    out["captured"] = _captured_solves(store, edges)
    return out


def _prefix_graph(store, edges, n: int):
    """The first ``n`` keyframes of a graph: the node mask and the valid
    edges between them, moved to the front of the store (stable), the rest
    invalid with their stale indices. Returns ``(edges, mask, count)``."""
    import torch

    from icpslam_tpu_torch.graph import pose_graph as pg

    dev = edges.i.device
    keep = edges.valid & (edges.i < n) & (edges.j < n)
    order = torch.argsort((~keep).to(torch.int8), stable=True)
    m = int(keep.sum())
    sub = pg.EdgeSet(
        i=edges.i[order], j=edges.j[order], rel_t=edges.rel_t[order], rel_q=edges.rel_q[order],
        info=edges.info[order], valid=torch.arange(edges.capacity, device=dev) < m,
        count=torch.full((), m, dtype=torch.int32, device=dev), overflow=edges.overflow,
    )
    return sub, torch.arange(store.capacity, device=dev) < n, m


def _captured_solves(store, edges) -> dict:
    """Phase 10's second part: each captured solve against its eager
    solve on phase 9's graph — direct on the 64-, 128- and 256-node
    prefixes, PCG on all of it ('auto' on their buckets), the window."""
    import functools

    import torch

    from icpslam_tpu_torch.config import kitti_config
    from icpslam_tpu_torch.graph import captured
    from icpslam_tpu_torch.graph import pose_graph as pg

    cfg = kitti_config()
    kw = dict(iterations=cfg.graph_solver_iterations, mode=cfg.graph_solver)
    K, E = store.capacity, edges.capacity
    nodes = store.pose_graph
    solves = captured.CapturedSolves(nodes.t.device)
    out = {}
    for n in (64, 128, 256, int(store.count)):
        sub, mask, m = _prefix_graph(store, edges, n)
        bucket = pg.bucket_size(n, m, K, E, cfg.graph_bucket_min)
        solver = pg.resolve_linear_solver(cfg.graph_linear_solver, bucket)
        args = (nodes, sub, mask, bucket, solver)
        out[f"{solver} {n}"] = dict(
            eager=functools.partial(pg.solve_bucket, *args, **kw),
            replay=functools.partial(solves.full, *args, **kw),
            nodes=n, edges=m, bucket=bucket)
    W = cfg.graph_window
    args = (nodes, edges, store.valid_mask(), store.count, W)
    out[f"window {W}"] = dict(
        eager=functools.partial(pg.optimize_window, *args, **kw),
        replay=functools.partial(solves.window, *args, **kw),
        nodes=int(store.count), edges=int(edges.count), bucket=W)
    res = {}
    for name, c in out.items():
        want, got = c["eager"](), c["replay"]()
        torch.cuda.synchronize()
        dist = float((got[0].t - want[0].t).norm(dim=-1).max())
        dq = float((got[0].q - want[0].q).abs().max())
        cost_rel = abs(float(got[1].final_cost) - float(want[1].final_cost)) / max(
            abs(float(want[1].final_cost)), 1e-30)
        r = res[name] = {
            "nodes": c["nodes"], "edges": c["edges"], "bucket": c["bucket"],
            "replay_ms": _timed(c["replay"], iters=5, warmup=1),
            "eager_ms": _timed(c["eager"], iters=5, warmup=1),
            "max_dist_m": dist, "max_dq": dq, "cost_rel": cost_rel,
            "initial_cost": float(want[1].initial_cost), "final_cost": float(want[1].final_cost),
        }
        print(f"[10] captured {name} (bucket {r['bucket']}, {r['nodes']} nodes, {r['edges']} "
              f"edges): replay {r['replay_ms']:.3f} ms, eager {r['eager_ms']:.2f} ms; poses "
              f"{dist:.3g} m / {dq:.3g} from eager, cost {r['final_cost']:.6g} ({cost_rel:.3g} rel)")
        if not (torch.isfinite(got[0].t).all() and torch.isfinite(got[0].q).all()):
            raise AssertionError(f"captured {name}: non-finite poses")
        if not (dist <= CAPTURED_DIST and dq <= CAPTURED_DIST and cost_rel <= CAPTURED_COST):
            raise AssertionError(f"captured {name}: {dist} m, {dq} in q, cost {cost_rel} rel from "
                                 f"the eager solve (> {CAPTURED_DIST} / {CAPTURED_COST})")
    res["graphs"] = len(solves.graphs)
    return res


def phase_deferred(dev, rendered, inline: dict):
    """Phase 11: the long mission with the deferred back end."""
    import dataclasses

    import numpy as np
    import torch

    from icpslam_tpu_torch.config import kitti_config
    from icpslam_tpu_torch.io import runner
    from icpslam_tpu_torch.pipeline import deferred

    cfg = dataclasses.replace(kitti_config(), defer_optimization=True)
    # as the runner's --deferred-optimize configures it
    backend = deferred.DeferredBackend(cfg, check_every=cfg.keyframes_window)
    n = len(rendered[0])
    s, launches, peak, res = _drive(runner.kitti_proxy_source, cfg, n, dev, rendered=rendered,
                                    backend=backend)
    active = sorted(set(backend.launched_at) | set(backend.folded_at))
    ms_all, ms_active = _ms_stats(res.step_ms), _ms_stats(res.step_ms, active)
    ms_capture = [res.step_ms[i] for i in backend.capture_calls]
    rec = res.records
    cap = cfg.max_keyframes
    kf_before = np.concatenate([[0.0], rec[:-1, 16]])
    evict_scans = np.nonzero((rec[:, 12] > 0) & (kf_before >= cap))[0]
    edges = res.state.edges
    count = int(edges.count)
    valid = edges.valid.cpu()
    prefix = bool(valid[:count].all()) and not bool(valid[count:].any())
    print(f"[11] deferred long mission, {n} scans: ATE {s['ate_m']:.4f} m (inline, phase 9: "
          f"{inline['ate_m']:.4f}), accepted {s['accepted']}/{n}, {s['keyframes']} keyframes, "
          f"{s['keyframe_evictions']} evictions, {s['edges']} edges, {s['loop_closures']} loop-closure edges, "
          f"{s['pcg_solves']} PCG solves, {s['window_solves']} window solves")
    print(f"[11] solves launched {backend.num_launched}, folded {backend.num_folded}, "
          f"{backend.folds_across_eviction} folds across an eviction; {len(ms_capture)} graph "
          f"captures at launch, on scans taking {[round(x, 1) for x in ms_capture]} ms")
    print(f"[11] ms/scan all: {_fmt(ms_all)}; launch or fold scans: {_fmt(ms_active)}")
    print(f"[9]  ms/scan all: {_fmt(inline['ms'])}; optimize scans: "
          f"{_fmt(inline['ms_optimize_scans'])}")
    print(f"[11] host syncs/scan {s['host_syncs_per_scan']:.2f} (phase 9: "
          f"{inline['host_syncs_per_scan']:.2f}); peak memory {peak / 2**20:.1f} MiB, graph pools "
          f"included (phase 9: {inline['peak_bytes'] / 2**20:.1f}); launches/scan K1 "
          f"{launches['nn1'] / n:.2f}, K2 {launches['knn'] / n:.2f}")
    if backend.num_launched != backend.num_folded or backend.num_launched < 1:
        raise AssertionError(f"launched {backend.num_launched}, folded {backend.num_folded}")
    if s["optimizations"] != backend.num_folded:
        raise AssertionError(f"{s['optimizations']} optimizations for {backend.num_folded} folds")
    if s["accepted"] < 0.9 * n:
        raise AssertionError(f"only {s['accepted']}/{n} scans accepted")
    if not s["ate_m"] <= LONG_ATE:
        raise AssertionError(f"deferred long mission ATE {s['ate_m']} > {LONG_ATE} m")
    if s["keyframes"] != cap or s["keyframe_evictions"] < 20 or s["keyframe_evictions"] != evict_scans.size:
        raise AssertionError(f"expected a full store of {cap} and >= 20 evictions, got "
                             f"{s['keyframes']} keyframes, {s['keyframe_evictions']} evictions")
    if s["pcg_solves"] < 3:
        raise AssertionError(f"{s['pcg_solves']} PCG solves")
    if not prefix:
        raise AssertionError(f"the edge store is not a valid prefix of {count}")
    if not (launches["nn1"] > 0 and launches["knn"] > 0):
        raise AssertionError(f"the deferred mission must run K1 and K2: {launches}")
    if not (torch.isfinite(res.state.keyframes.pose_graph.t).all()
            and torch.isfinite(res.state.keyframes.pose_graph.q).all()):
        raise AssertionError("non-finite graph poses")
    out = {**s, "peak_bytes": peak, "launched": backend.num_launched,
           "folded": backend.num_folded, "folds_across_eviction": backend.folds_across_eviction,
           "capture_scans": backend.capture_calls, "capture_scan_ms": ms_capture,
           "ms": ms_all, "ms_launch_or_fold_scans": ms_active}
    return out, launches


def _sync_sources(records, repo: str):
    """Host syncs that ``set_sync_debug_mode("warn")`` reported, by
    source: ``to_host`` (the counted reads), ``stream`` (a stream
    synchronize: the runner's step timer) and the rest by file:line."""
    import collections
    import os

    counted, stream, rest = 0, 0, collections.Counter()
    for r in records:
        f = r.filename.replace("\\", "/")
        if f.endswith("icpslam_tpu_torch/utils/sync.py"):
            counted += 1
        elif f.endswith("torch/cuda/streams.py"):
            stream += 1
        else:
            rel = os.path.relpath(f, repo) if f.startswith(repo) else f
            rest[f"{rel}:{r.lineno}"] += 1
    return counted, stream, rest


def phase_profile(dev, rendered):
    """Phase 12: a torch.profiler trace and the host syncs of the slice's
    40 scans (``rendered``), inline and deferred."""
    import dataclasses
    import os
    import warnings

    import torch

    from icpslam_tpu_torch.config import kitti_config
    from icpslam_tpu_torch.geometry.se3 import Pose
    from icpslam_tpu_torch.io import runner
    from icpslam_tpu_torch.pipeline import deferred
    from icpslam_tpu_torch.utils import profiling
    from icpslam_tpu_torch.utils.sync import to_host

    repo = os.path.dirname(os.path.abspath(__file__))
    n = len(rendered[0])
    gt = rendered[1]
    init = Pose(t=torch.from_numpy(gt[0][0]).to(dev), q=torch.from_numpy(gt[1][0]).to(dev))
    out = {}
    for mode in ("inline", "deferred"):
        cfg = dataclasses.replace(kitti_config(), defer_optimization=mode == "deferred")
        shared = None
        for run in ("warm", "profiled"):
            backend = (deferred.DeferredBackend(cfg, check_every=cfg.keyframes_window,
                                                captured=shared)
                       if mode == "deferred" else None)
            post = backend.maybe_launch_or_fold if backend is not None else None
            if run == "warm":
                res = runner.run_slam(rendered[0], cfg, init, dev, post_step=post)
                if backend is not None:
                    # the profiled run's backend replays the same graphs
                    backend.flush(res.state)
                    shared = backend.captured
                continue
            logdir = os.path.join(repo, TRACE_DIR, f"phase12_{mode}")
            s0 = to_host.count
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as recs:
                    warnings.simplefilter("always")
                    with profiling.trace(logdir):
                        res = runner.run_slam(rendered[0], cfg, init, dev, post_step=post)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            wall = time.perf_counter() - t0
            if backend is not None:
                res.state = backend.flush(res.state)
            counted_calls = to_host.count - s0
            syncs = [r for r in recs if "synchronizing CUDA operation" in str(r.message)]
            counted, stream, rest = _sync_sources(syncs, repo)
            summ = profiling.device_summary(logdir)
            r = out[mode] = {
                "scans": n, "wall_s": wall, **{k: summ[k] for k in (
                    "window_us", "device_busy_us", "device_busy_share", "kernels", "launch_calls",
                    "graph_launches", "top")},
                "kernels_per_scan": summ["kernels"] / n,
                "launch_calls_per_scan": summ["launch_calls"] / n,
                "to_host_per_scan": counted_calls / n, "sync_warnings_per_scan": len(syncs) / n,
                "to_host_warnings_per_scan": counted / n, "stream_syncs_per_scan": stream / n,
                "implicit_syncs_per_scan": sum(rest.values()) / n,
                "implicit_sources": dict(rest.most_common(8)),
                "step_ms": _ms_stats(res.step_ms),
                "solves": int(res.state.num_optimizations),
            }
            print(f"[12] {mode}, {n} scans profiled (trace {os.path.relpath(logdir, repo)}): device "
                  f"busy {100 * r['device_busy_share']:.1f}% of {r['window_us'] / 1e3:.1f} ms; "
                  f"{r['kernels_per_scan']:.0f} kernels and {r['launch_calls_per_scan']:.0f} host "
                  f"launch calls per scan ({r['graph_launches']} graph launches); ms/scan under the "
                  f"profiler {_fmt(r['step_ms'])}")
            for x in r["top"]:
                print(f"[12] {mode} top device op: {x['total_us'] / 1e3:.2f} ms in {x['calls']} "
                      f"calls, {x['name'][:100]}")
            print(f"[12] {mode} host syncs per scan: {r['sync_warnings_per_scan']:.2f} reported "
                  f"by set_sync_debug_mode('warn') = {r['to_host_warnings_per_scan']:.2f} counted "
                  f"to_host reads (to_host.count: {r['to_host_per_scan']:.2f}) + "
                  f"{r['stream_syncs_per_scan']:.2f} step-timer stream syncs + "
                  f"{r['implicit_syncs_per_scan']:.2f} implicit; implicit sources "
                  f"{r['implicit_sources']}")
            if summ["kernels"] < n:
                raise AssertionError(f"the {mode} trace holds {summ['kernels']} kernels for {n} "
                                     "scans: the profiler saw no device activity")
            if r["solves"] < 1:
                raise AssertionError(f"no graph solve in the {mode} profile")
    return out


def _odometry_drive(scans, init, cfg, dev, chunk: int = 0, count_syncs: bool = False):
    """Phase 30: the odometry front end alone over the uploaded ``scans``
    (a stacked cloud on the card): ``odometry.run_scans`` in chunks of
    ``chunk`` scans, or ``odometry_step(state, scan, cfg)`` one scan at a
    time (``chunk`` 0). Every launch count is set to 0 just before and read
    just after. Returns the final state, the stacked outputs, ms per scan
    (a chunk's time over its scans), the counted host reads, the implicit
    syncs by source (``count_syncs``: under ``set_sync_debug_mode('warn')``)
    and the launches, with K1's and K2's per scan in the one-by-one drive."""
    import os
    import warnings

    import torch

    from icpslam_tpu_torch.cloud import pointcloud as pc
    from icpslam_tpu_torch.io import runner
    from icpslam_tpu_torch.pipeline import odometry
    from icpslam_tpu_torch.utils import tree
    from icpslam_tpu_torch.utils.sync import to_host

    n = scans.points.shape[0]
    state = odometry.init_state(cfg, initial_pose=init, device=dev)
    for fn in runner.KERNELS.values():
        fn.launches = 0
    nn1, knn = runner.KERNELS["nn1"], runner.KERNELS["knn"]
    reads0 = to_host.count
    ms, outs, per_scan = [], [], []
    torch.cuda.synchronize()
    if count_syncs:
        torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as recs:
            warnings.simplefilter("always")
            for a in range(0, n, chunk or 1):
                b = min(a + (chunk or 1), n)
                k0 = (nn1.launches, knn.launches)
                t0 = time.perf_counter()
                if chunk:
                    state, out = odometry.run_scans(
                        state, pc.PointCloud(scans.points[a:b], scans.mask[a:b]), cfg)
                else:
                    state, out = odometry.odometry_step(
                        state, pc.PointCloud(scans.points[a], scans.mask[a]), cfg)
                torch.cuda.synchronize()
                ms += [1e3 * (time.perf_counter() - t0) / (b - a)] * (b - a)
                outs.append(out)
                per_scan.append((nn1.launches - k0[0], knn.launches - k0[1]))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    reads = to_host.count - reads0
    stacked = tree.cat(outs) if chunk else tree.stack(outs)
    syncs = [r for r in recs if "synchronizing CUDA operation" in str(r.message)]
    counted, stream, rest = _sync_sources(syncs, os.path.dirname(os.path.abspath(__file__)))
    launches = {name: fn.launches for name, fn in runner.KERNELS.items()}
    return {"state": state, "out": stacked, "ms": ms, "reads": reads, "syncs": len(syncs),
            "counted_syncs": counted, "stream_syncs": stream, "implicit": sum(rest.values()),
            "implicit_sources": dict(rest.most_common(5)), "launches": launches,
            "per_scan": per_scan}


def phase_odometry(dev, rendered, map_pts, fill, query_world):
    """Phase 30: the odometry front end as an entry point of its own on
    phase 5's scans (``rendered``), at ``kitti_config()``'s full width:
    ``odometry.run_scans`` in chunks of ODOM_CHUNK (as JAX's
    ``bench_odometry`` drives it) and ``odometry_step(state, scan, cfg)``
    one scan at a time, bit-equal; K1 and K2 in every registered scan;
    ``drain_accumulator``; ``point_map.exact_nn`` against
    ``exact_nn_with_covs`` on phase 2's map."""
    import numpy as np
    import torch

    from icpslam_tpu_torch.cloud import pointcloud as pc
    from icpslam_tpu_torch.config import kitti_config
    from icpslam_tpu_torch.eval import metrics
    from icpslam_tpu_torch.geometry import se3
    from icpslam_tpu_torch.geometry.se3 import Pose
    from icpslam_tpu_torch.mapping import point_map
    from icpslam_tpu_torch.ops.covariance import eye6
    from icpslam_tpu_torch.pipeline import odometry
    from icpslam_tpu_torch.utils.tree import leaves

    cfg = kitti_config()
    stream, gt = rendered
    n = len(stream)
    scans = pc.PointCloud(torch.from_numpy(np.stack([p for (p, _), _ in stream])).to(dev),
                          torch.from_numpy(np.stack([m for (_, m), _ in stream])).to(dev))
    init = Pose(t=torch.from_numpy(gt[0][0]).to(dev), q=torch.from_numpy(gt[1][0]).to(dev))
    drives = {}
    # the drives that count syncs go first: they also warm the timed ones
    for name, chunk in (("chunks", ODOM_CHUNK), ("one_by_one", 0)):
        drives[name + "_syncs"] = _odometry_drive(scans, init, cfg, dev, chunk=chunk,
                                                  count_syncs=True)
    for name, chunk in (("chunks", ODOM_CHUNK), ("one_by_one", 0)):
        drives[name] = _odometry_drive(scans, init, cfg, dev, chunk=chunk)
    a, b = drives["chunks"], drives["one_by_one"]
    equal = all(torch.equal(x, y) for x, y in zip(leaves(a["out"]), leaves(b["out"])))
    equal &= all(torch.equal(x, y) for x, y in zip(leaves(a["state"]), leaves(b["state"])))
    for name in ("chunks", "one_by_one"):
        d = drives[name + "_syncs"]
        equal &= all(torch.equal(x, y) for x, y in zip(leaves(d["out"]), leaves(b["out"])))
    out = b["out"]
    processed = out.processed.cpu().numpy()
    accepted = out.accepted.cpu().numpy()
    t, q = out.pose.t.cpu(), out.pose.q.cpu()
    finite = bool(torch.isfinite(t).all() and torch.isfinite(q).all())
    missing = [i for i, (k1, k2) in enumerate(b["per_scan"])
               if processed[i] and not (k1 > 0 and k2 > 0)]
    ate, _ = metrics.ate(Pose(t, q), Pose(torch.from_numpy(gt[0][:n]), torch.from_numpy(gt[1][:n])),
                         align=True)
    accum, drained = odometry.drain_accumulator(b["state"])
    expect = se3.relative(init, b["state"].pose)
    drain_err = float((accum.t - expect.t).norm())
    accum2, _ = odometry.drain_accumulator(drained)
    second = float(accum2.t.norm()) + float((accum2.q - se3.identity(device=dev).q).abs().max())
    # the map query: exact_nn is exact_nn_with_covs without the gather
    pmap = point_map.PointMap(points=map_pts, covs=eye6(map_pts.shape[0], device=dev),
                              size=torch.tensor(fill, dtype=torch.int32, device=dev),
                              overflow=torch.tensor(0, dtype=torch.int32, device=dev))
    nn_a = point_map.exact_nn(pmap, query_world.points, query_world.mask)
    nn_b, _ = point_map.exact_nn_with_covs(pmap, query_world.points, query_world.mask)
    nn_equal = all(torch.equal(x, y) for x, y in zip(nn_a, nn_b))
    registered = int(processed.sum())
    res = {"scans": n, "chunk": ODOM_CHUNK, "bit_equal": bool(equal),
           "accepted": int(accepted.sum()), "registered": registered, "ate_m": float(ate),
           "drain_err_m": drain_err, "second_drain": second, "map_nn_equal": bool(nn_equal),
           "map_queries": int(query_world.mask.sum()), "map_fill": fill}
    for name in ("chunks", "one_by_one"):
        d, s = drives[name], drives[name + "_syncs"]
        res[name] = {"ms": _ms_stats(d["ms"]), "to_host_per_scan": d["reads"] / n,
                     "syncs_per_scan": s["syncs"] / n, "counted_syncs_per_scan": s["counted_syncs"] / n,
                     "stream_syncs_per_scan": s["stream_syncs"] / n,
                     "implicit_syncs_per_scan": s["implicit"] / n,
                     "implicit_sources": s["implicit_sources"], "launches": d["launches"]}
    launches = b["launches"]
    print(f"[30] odometry front end, {n} scans of phase 5 at kitti_config width: run_scans in "
          f"chunks of {ODOM_CHUNK} and odometry_step one by one bit-equal (outputs and state): "
          f"{equal}; accepted {res['accepted']}/{n}, registered {registered}, poses finite "
          f"{finite}; odometry-only ATE {ate:.4f} m (no limit)")
    for name in ("chunks", "one_by_one"):
        r = res[name]
        print(f"[30] {name}: ms/scan {_fmt(r['ms'])}; host syncs/scan "
              f"{r['syncs_per_scan']:.2f} (set_sync_debug_mode) = {r['counted_syncs_per_scan']:.2f} "
              f"counted to_host + {r['stream_syncs_per_scan']:.2f} stream + "
              f"{r['implicit_syncs_per_scan']:.2f} implicit {r['implicit_sources']}; to_host "
              f"reads/scan {r['to_host_per_scan']:.2f}; K1 {r['launches']['nn1'] / n:.2f} and K2 "
              f"{r['launches']['knn'] / n:.2f} launches/scan")
    print(f"[30] drain_accumulator against se3.relative(initial, final): {drain_err:.2e} m; "
          f"second drain off identity by {second:.2e}; point_map.exact_nn equals "
          f"exact_nn_with_covs (points, d², found) on phase 2's map ({res['map_queries']} queries, "
          f"fill {fill}): {nn_equal}")
    if not equal:
        raise AssertionError("run_scans differs from odometry_step one by one")
    if missing:
        raise AssertionError(f"registered scans without K1 and K2 launches: {missing}")
    if a["launches"] != launches:
        raise AssertionError(f"the two drives launched different kernels: {a['launches']} "
                             f"against {launches}")
    if res["accepted"] < 0.9 * n or not finite:
        raise AssertionError(f"odometry: {res['accepted']}/{n} accepted, finite {finite}")
    if not (drain_err <= 1e-4 and second == 0.0):
        raise AssertionError(f"drain_accumulator: {drain_err} m, second drain {second}")
    if not nn_equal:
        raise AssertionError("point_map.exact_nn differs from exact_nn_with_covs")
    return res


def _physics_drive(dev, tag: str, rendered, cfg, prefetch_depth=3):
    """One drive of the physics proxy (phases 13-15): the summary, the
    launch counts and the runner's result, after the checks every such
    drive must pass: K1 launched in every registered scan, at least once
    per GN iteration of the odometry, and K2 once per scan at least."""
    import numpy as np

    from icpslam_tpu_torch.io import runner

    n = len(rendered[0])
    s, launches, peak, res = _drive(runner.kitti_proxy_source, cfg, n, dev, rendered=rendered,
                                    prefetch_depth=prefetch_depth)
    reg = np.asarray(res.processed, bool)
    k1 = np.asarray(res.launches["nn1"])
    iters = res.records[:, 10]
    if not (k1[reg] > 0).all() or (k1[reg] < iters[reg]).any():
        raise AssertionError(f"{tag}: K1 not launched in every registered scan "
                             f"({int((k1[reg] == 0).sum())} registered scans without it)")
    if launches["knn"] < n:
        raise AssertionError(f"{tag}: K2 launched {launches['knn']} times for {n} scans")
    s = {**s, "peak_bytes": peak, "ms": _ms_stats(res.step_ms),
         "gn_iterations_per_registered_scan": float(iters[reg].mean()) if reg.any() else 0.0}
    return s, launches, res


def _physics_line(tag: str, s: dict, launches: dict, n: int) -> str:
    return (f"[{tag}] ATE {s['ate_m']:.4f} m, accepted {s['accepted']}/{n}, {s['keyframes']} "
            f"keyframes, {s['loop_closures']} loop-closure edges; ms/scan {_fmt(s['ms'])}; GN "
            f"iterations/registered scan {s['gn_iterations_per_registered_scan']:.2f}; host "
            f"syncs/scan {s['host_syncs_per_scan']:.2f}; launches/scan K1 "
            f"{launches['nn1'] / n:.2f} (scan target {launches['nn1_scan'] / n:.2f}, map "
            f"{launches['nn1_map'] / n:.2f}), K2 {launches['knn'] / n:.2f}; peak memory "
            f"{s['peak_bytes'] / 2**20:.1f} MiB")


def phase_physics(dev):
    """Phases 13-15: the physics proxy with the in-loop coupled de-skew,
    with the INS de-skew at ingest, and the other in-loop modes."""
    import numpy as np

    from icpslam_tpu_torch.config import kitti_config
    from icpslam_tpu_torch.io import runner, synthetic

    n = PHYSICS_SCANS
    t0 = time.perf_counter()
    stream, gt = runner.kitti_proxy_source(kitti_config(), n, 10.0, physics=True)
    scans = list(stream)
    render_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ins_scans = list(synthetic.ins_deskew_stream(scans, gt))
    ins_s = time.perf_counter() - t0
    print(f"[13] rendered {n} physics scans on the host in {render_s:.1f} s "
          f"({1e3 * render_s / n:.1f} ms/scan, kept apart from the step times); "
          f"INS de-skew of them {ins_s:.1f} s")
    out = {"render_s": render_s, "ins_deskew_s": ins_s}

    cfg = kitti_config(deskew_rounds=1, deskew_free_twist=True)
    s, launches, res13 = _physics_drive(dev, "13", (scans, gt), cfg)
    print(_physics_line("13", s, launches, n) + " (coupled, free twist; prefetch depth 3)")
    if s["accepted"] < 0.9 * n:
        raise AssertionError(f"physics mission: only {s['accepted']}/{n} scans accepted")
    if not s["ate_m"] <= PHYSICS_ATE:
        raise AssertionError(f"physics mission ATE {s['ate_m']} > {PHYSICS_ATE} m")
    out["physics"], out["physics_launches"] = s, launches
    # the same drive with the scans prepared and uploaded inline, then at
    # depth 3 again: the first drive also pays the path's first use
    out["prefetch"] = []
    for depth in (0, 3):
        s0, _, res0 = _physics_drive(dev, "13", (scans, gt), cfg, prefetch_depth=depth)
        print(f"[13] prefetch depth {depth}, again: ms/scan {_fmt(s0['ms'])}; wall "
              f"{s0['wall_time_s']:.2f} s (the first drive, depth 3: {s['wall_time_s']:.2f} s)")
        if not np.array_equal(res0.records, res13.records):
            diff = np.abs(res0.records - res13.records)
            raise AssertionError(f"physics mission at depth {depth}: the records changed (max "
                                 f"|diff| {float(np.nanmax(diff))}, first rows "
                                 f"{np.unique(np.argwhere(diff > 0)[:, 0])[:5]})")
        out["prefetch"].append({"depth": depth, "ms": s0["ms"], "wall_time_s": s0["wall_time_s"]})
    del res0, res13

    s, launches, _ = _physics_drive(dev, "14", (ins_scans, gt), kitti_config())
    print(_physics_line("14", s, launches, n) + " (INS de-skew at ingest)")
    if s["accepted"] < 0.9 * n:
        raise AssertionError(f"INS mission: only {s['accepted']}/{n} scans accepted")
    if not s["ate_m"] <= INS_ATE:
        raise AssertionError(f"INS mission ATE {s['ate_m']} > {INS_ATE} m")
    out["ins"], out["ins_launches"] = s, launches
    del ins_scans

    m = MODES_SCANS
    first = (scans[:m], (gt[0][:m], gt[1][:m]))
    modes = {"coupled cv-tied": dict(deskew_rounds=1),
             "joint": dict(deskew_rounds=1, deskew_mode="joint"),
             "alternate": dict(deskew_rounds=2, deskew_mode="alternate")}
    out["modes"] = {}
    for name, kw in modes.items():
        s, launches, _ = _physics_drive(dev, "15", first, kitti_config(**kw))
        ref = JAX_MODE_ATE.get(name)
        print(_physics_line("15", s, launches, m) + f" ({name}"
              + (f"; JAX, docs/DESIGN.md §14: {ref} m)" if ref else ")"))
        if name == "coupled cv-tied" and not s["ate_m"] <= CV_ATE:
            raise AssertionError(f"coupled cv-tied ATE {s['ate_m']} > {CV_ATE} m")
        out["modes"][name] = {**s, "launches": launches}
    return out, (scans, gt)


def phase_voxel(dev):
    """Phase 16: phase 5's slice with the voxel map."""
    from icpslam_tpu_torch.config import kitti_config
    from icpslam_tpu_torch.io import runner

    n = 40
    cfg = kitti_config(map_backend="voxel")
    s, launches, peak, res = _drive(runner.kitti_proxy_source, cfg, n, dev)
    refined = int(res.records[:, 11].sum())
    print(f"[16] voxel map, {n} scans: ATE {s['ate_m']:.4f} m, accepted {s['accepted']}/{n}, "
          f"{refined} scans refined, map size {s['map_size']}, overflow {s['map_overflow']}; "
          f"ms/scan median {s['step_ms_p50']:.2f} p90 {s['step_ms_p90']:.2f}; launches/scan K1 "
          f"{launches['nn1'] / n:.2f}, K2 {launches['knn'] / n:.2f} (the odometry's "
          f"{s['processed'] / n:.2f} + the NN clouds'); peak memory {peak / 2**20:.1f} MiB")
    if s["accepted"] < 0.9 * n:
        raise AssertionError(f"voxel map: only {s['accepted']}/{n} scans accepted")
    if not s["ate_m"] <= VOXEL_ATE:
        raise AssertionError(f"voxel map ATE {s['ate_m']} > {VOXEL_ATE} m")
    if launches["knn"] < s["processed"] + refined or refined < 1:
        raise AssertionError(f"voxel map: K2 launched {launches['knn']} times for "
                             f"{s['processed']} registrations and {refined} refinements")
    if launches["nn1_map"] != 0:
        raise AssertionError("voxel map: K1 ran on a map-sized target")
    return {**s, "peak_bytes": peak, "refined": refined}, launches, res.records


def _runner_main(argv):
    """``runner.main(argv)`` with every launch count set to 0 just before
    it and read just after; its stdout (the summary line) is kept out of
    this script's. Returns the launches by kernel."""
    import contextlib
    import io

    from icpslam_tpu_torch.io import runner

    for fn in runner.KERNELS.values():
        fn.launches = 0
    with contextlib.redirect_stdout(io.StringIO()):
        if runner.main(argv) != 0:
            raise AssertionError(f"runner.main({argv}) failed")
    return {name: fn.launches for name, fn in runner.KERNELS.items()}


def _tree_line(tag: str, s: dict, launches: dict) -> str:
    n = s["scans"]
    return (f"[{tag}] ATE {s['ate_m']:.4f} m, accepted {s['accepted']}/{n}, {s['keyframes']} "
            f"keyframes, {s['loop_closures']} loop-closure edges; ms/scan median "
            f"{s['step_ms_p50']:.2f} p90 {s['step_ms_p90']:.2f} p99 {s['step_ms_p99']:.2f} max "
            f"{s['step_ms_max']:.2f}; host syncs/scan {s['host_syncs_per_scan']:.2f}; "
            f"launches/scan K1 {launches['nn1'] / n:.2f}, K2 {launches['knn'] / n:.2f}; "
            f"loader {s['loader']}")


def _check_tree_run(tag: str, s: dict, launches: dict) -> None:
    n = s["scans"]
    if s["loader"] != "native":
        raise AssertionError(f"{tag}: the runner read the tree with the {s['loader']} reader")
    if s["accepted"] < 0.9 * n:
        raise AssertionError(f"{tag}: only {s['accepted']}/{n} scans accepted")
    if not s["ate_m"] <= PHYSICS_ATE:
        raise AssertionError(f"{tag}: ATE {s['ate_m']} > {PHYSICS_ATE} m")
    missed = s["registered_scans_without_launch"]
    if missed["nn1"] or missed["knn"] or not (launches["nn1"] and launches["knn"]):
        raise AssertionError(f"{tag}: K1/K2 not launched in every registered scan: {missed}, "
                             f"launches {launches}")


def _tail_ate(t, q, gt, lo: int) -> float:
    """ATE (m, SE(3)-aligned) of trajectory rows ``lo:`` against the ground truth's."""
    import torch

    from icpslam_tpu_torch.eval import metrics
    from icpslam_tpu_torch.geometry.se3 import Pose

    est = Pose(torch.from_numpy(t[lo:]), torch.from_numpy(q[lo:]))
    ref = Pose(torch.from_numpy(gt[0][lo:]), torch.from_numpy(gt[1][lo:]))
    return float(metrics.ate(est, ref, align=True)[0])


def phase_kitti_tree(dev, rendered, physics: dict):
    """Phases 17-18: phase 13's scans as a KITTI tree on disk, driven
    through the runner's own entry point with the native loader, with
    every product written and read back; then the same tree split at
    RESUME_AT into a run that checkpoints and a run that resumes."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from icpslam_tpu_torch.config import kitti_config
    from icpslam_tpu_torch.io import kitti, native_loader
    from icpslam_tpu_torch.pipeline import slam
    from icpslam_tpu_torch.utils import checkpoint

    scans, gt = rendered
    n = len(scans)
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="_kitti_tree_", dir=here)
    try:
        t0 = time.perf_counter()
        kitti.write_tree(tmp, TREE_SEQ, (p[m] for (p, m), _ in scans), gt)
        write_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(tmp) for f in fs)
        print(f"[17] wrote {n} scans as a KITTI tree in {write_s:.1f} s ({size / 2**30:.2f} GiB); "
              f"native loader built: {native_loader.available()}")
        prod = {k: os.path.join(tmp, f) for k, f in (
            ("out", "traj.npz"), ("summary", "summary.json"), ("state", "state.npz"),
            ("html", "view.html"))}
        deskew = ["--deskew-rounds", "1", "--deskew-free-twist"]
        common = ["--kitti", tmp, "--seq", TREE_SEQ, *deskew, "--verbosity", "0",
                  "--device", str(dev)]
        launches = _runner_main([*common, "--out", prod["out"], "--summary-out", prod["summary"],
                                 "--save-state", prod["state"], "--html", prod["html"]])
        with open(prod["summary"]) as f:
            s = json.load(f)
        print(_tree_line("17", s, launches))
        p13 = physics["physics"]
        print(f"[17] phase 13 over the same scans in memory: ATE {p13['ate_m']:.4f} m, ms/scan "
              f"{_fmt(p13['ms'])}, host syncs/scan {p13['host_syncs_per_scan']:.2f}, launches/scan "
              f"K1 {physics['physics_launches']['nn1'] / n:.2f}, K2 "
              f"{physics['physics_launches']['knn'] / n:.2f}")
        _check_tree_run("17", s, launches)
        # every product read back
        traj = dict(np.load(prod["out"]))
        if sorted(traj) != ["gt_q", "gt_t", "q", "t"] or traj["t"].shape != (n, 3):
            raise AssertionError(f"trajectory file: {sorted(traj)}, {traj['t'].shape}")
        if not np.isfinite(traj["t"]).all():
            raise AssertionError("non-finite poses in the trajectory file")
        cfg = kitti_config(deskew_rounds=1, deskew_free_twist=True)
        state = checkpoint.load(prod["state"], slam.init_state(cfg, device=dev))
        if int(state.keyframes.count) != s["keyframes"]:
            raise AssertionError(f"checkpoint holds {int(state.keyframes.count)} keyframes, "
                                 f"the run {s['keyframes']}")
        html_bytes = os.path.getsize(prod["html"])
        with open(prod["html"]) as f:
            if "const DATA = {" not in f.read():
                raise AssertionError("the viewer holds no data")
        print(f"[17] products read back: trajectory {traj['t'].shape}, summary "
              f"{len(s)} keys, checkpoint {os.path.getsize(prod['state']) / 2**20:.1f} MiB "
              f"({int(state.keyframes.count)} keyframes), viewer {html_bytes / 2**20:.1f} MiB")
        tree = {**s, "launches": launches, "write_s": write_s, "bytes": size}

        # phase 18: checkpoint at RESUME_AT, resume to the end
        ck = os.path.join(tmp, "head.npz")
        head_launches = _runner_main([*common, "--end", str(RESUME_AT), "--save-state", ck,
                                      "--summary-out", prod["summary"]])
        with open(prod["summary"]) as f:
            head = json.load(f)
        tail_out = os.path.join(tmp, "tail.npz")
        tail_launches = _runner_main([*common, "--start", str(RESUME_AT), "--resume", ck,
                                      "--out", tail_out, "--summary-out", prod["summary"]])
        with open(prod["summary"]) as f:
            tail = json.load(f)
        tail_traj = dict(np.load(tail_out))
        full_tail = _tail_ate(traj["t"], traj["q"], (traj["gt_t"], traj["gt_q"]), RESUME_AT)
        print(f"[18] head {head['scans']} scans: ATE {head['ate_m']:.4f} m, {head['keyframes']} "
              f"keyframes; resumed from {tail['resumed_keyframes']} keyframes (map re-rendered: "
              f"{tail['resumed_map_size']} points)")
        print(_tree_line("18", tail, tail_launches) + f"; phase 17 over the same scans: ATE "
              f"{full_tail:.4f} m")
        if tail["resumed_keyframes"] != head["keyframes"]:
            raise AssertionError(f"resumed from {tail['resumed_keyframes']} keyframes, the "
                                 f"checkpoint holds {head['keyframes']}")
        if tail["resumed_map_size"] <= 0:
            raise AssertionError("the resumed map is empty")
        if not (np.isfinite(tail_traj["t"]).all() and np.isfinite(tail_traj["q"]).all()):
            raise AssertionError("non-finite poses after the resume")
        if tail["scans"] != n - RESUME_AT:
            raise AssertionError(f"the resumed run drove {tail['scans']} scans")
        _check_tree_run("18", tail, tail_launches)
        _check_tree_run("18 head", head, head_launches)
        resume = {"head": {**head, "launches": head_launches},
                  "tail": {**tail, "launches": tail_launches}, "full_tail_ate_m": full_tail}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return tree, resume


def phase_chunk(dev, slice_records):
    """Phase 19: phase 5's scans through ``runner.run_slam`` in chunks
    (``slam.run_scans``), equal to phase 5's one-step drive bit for bit."""
    import numpy as np
    import torch

    from icpslam_tpu_torch.config import kitti_config
    from icpslam_tpu_torch.geometry.se3 import Pose
    from icpslam_tpu_torch.io import runner

    n = SLICE_SCANS
    rendered = _render(runner.kitti_proxy_source, kitti_config(), n)
    gt = rendered[1]
    init = Pose(t=torch.from_numpy(gt[0][0]).to(dev), q=torch.from_numpy(gt[1][0]).to(dev))
    out = {}
    for chunk in CHUNKS:
        for fn in runner.KERNELS.values():
            fn.launches = 0
        res = runner.run_slam(rendered[0], kitti_config(), init, dev, chunk=chunk)
        launches = {name: fn.launches for name, fn in runner.KERNELS.items()}
        pad = -n % chunk
        equal = bool(np.array_equal(res.records, slice_records))
        print(f"[19] chunks of {chunk} ({n // chunk} full, tail of {n % chunk} padded with {pad}): "
              f"records {res.records.shape} equal to phase 5's bit for bit: {equal}; ms/scan "
              f"median {np.median(res.step_ms):.2f}; launches/scan K1 {launches['nn1'] / n:.2f}, "
              f"K2 {launches['knn'] / n:.2f}")
        if not equal:
            diff = np.abs(res.records - slice_records)
            raise AssertionError(f"chunk {chunk}: records differ from phase 5's (max "
                                 f"|diff| {float(np.nanmax(diff))} at {np.argwhere(diff > 0)[:3]})")
        if not (launches["nn1"] and launches["knn"]):
            raise AssertionError(f"chunk {chunk}: K1/K2 not launched: {launches}")
        out[chunk] = {"launches": launches, "padded": pad}
    return out


def phase_sharded(dev, voxel: dict, voxel_launches: dict, voxel_records):
    """Phase 20: phase 5's slice with ``map_backend='sharded'`` on a mesh
    of 1 shard (records equal to phase 16's voxel drive bit for bit) and
    of SHARDS shards (JAX's assertions against the voxel drive), both
    without a process group. Returns the results and the SHARDS drive's
    records."""
    import numpy as np

    from icpslam_tpu_torch.config import kitti_config
    from icpslam_tpu_torch.io import runner
    from icpslam_tpu_torch.parallel import mesh as mesh_lib

    n = SLICE_SCANS
    out, records = {}, None
    for d in (1, SHARDS):
        cfg = kitti_config(map_backend="sharded", map_shards=d)
        mesh = mesh_lib.make_mesh(d, device=dev)
        s, launches, peak, res = _drive(runner.kitti_proxy_source, cfg, n, dev, mesh=mesh)
        sizes = res.state.map.size.cpu().numpy()
        dist = float(np.linalg.norm(res.records[:, :3] - voxel_records[:, :3], axis=-1).max())
        equal = bool(np.array_equal(res.records, voxel_records))
        out[d] = {**s, "peak_bytes": peak, "launches": launches, "shard_sizes": sizes.tolist(),
                  "max_dist_to_voxel_m": dist, "records_equal_voxel": equal}
        print(f"[20] sharded map, {d} shard(s), {n} scans: records equal to phase 16's bit for "
              f"bit: {equal}; max |t - voxel t| {dist:.3g} m; ATE {s['ate_m']:.4f} m; map "
              f"{s['map_size']} voxels (phase 16: {voxel['map_size']}), shards {sizes.tolist()}, "
              f"overflow {s['map_overflow']} ({voxel['map_overflow']}); {s['keyframes']} "
              f"keyframes, {s['optimizations']} optimizations, {s['loop_closures']} loop closures")
        print(f"[20] ms/scan median {s['step_ms_p50']:.2f} p90 {s['step_ms_p90']:.2f} (phase 16: "
              f"{voxel['step_ms_p50']:.2f} / {voxel['step_ms_p90']:.2f}); host syncs/scan "
              f"{s['host_syncs_per_scan']:.2f} ({voxel['host_syncs_per_scan']:.2f}); launches/scan "
              f"K1 {launches['nn1'] / n:.2f} ({voxel_launches['nn1'] / n:.2f}), K2 "
              f"{launches['knn'] / n:.2f} ({voxel_launches['knn'] / n:.2f}); peak memory "
              f"{peak / 2**20:.1f} MiB ({voxel['peak_bytes'] / 2**20:.1f})")
        if not (launches["nn1"] > 0 and launches["knn"] > 0):
            raise AssertionError(f"sharded map, {d} shards: K1/K2 not launched: {launches}")
        if d == 1:
            if not equal:
                diff = np.abs(res.records - voxel_records)
                raise AssertionError(f"one shard: records differ from the voxel map's (max "
                                     f"|diff| {float(np.nanmax(diff))} at "
                                     f"{np.argwhere(diff > 0)[:3].tolist()})")
            continue
        records = res.records
        if not dist <= SHARDED_DIST:
            raise AssertionError(f"{d} shards: trajectory {dist} m from the voxel map's "
                                 f"(> {SHARDED_DIST})")
        for key in ("map_size", "map_overflow", "keyframes", "optimizations", "loop_closures"):
            if s[key] != voxel[key]:
                raise AssertionError(f"{d} shards: {key} {s[key]} against the voxel map's "
                                     f"{voxel[key]}")
    return out, records


def phase_dist_solvers(dev, state, solvers: dict, slice_summary: dict):
    """Phase 21: dist-direct, dist-pcg and dist-schur on phase 9's graph
    over SHARDS shards against the replicated solvers of phase 10, eager
    and captured; then phase 5's slice with ``graph_incremental=False`` and
    'dist-schur' against 'direct'."""
    import functools

    import numpy as np
    import torch

    from icpslam_tpu_torch.config import kitti_config
    from icpslam_tpu_torch.graph import captured
    from icpslam_tpu_torch.graph import pose_graph as pg
    from icpslam_tpu_torch.graph import schur
    from icpslam_tpu_torch.io import runner
    from icpslam_tpu_torch.parallel import dist_graph
    from icpslam_tpu_torch.parallel import mesh as mesh_lib

    store, edges = state.keyframes, state.edges
    nodes, mask = store.pose_graph, store.valid_mask()
    K = store.capacity
    mesh = mesh_lib.make_mesh(SHARDS, device=dev)
    kw = dict(iterations=3, mode="lm")   # as phase 10: LM, 3 iterations
    chunk, sep_capacity = K // SHARDS, solvers["sep_capacity"]
    n_sep = int(schur.separator_mask(edges.i, edges.j, edges.valid, K, chunk).sum())
    dist_fn = functools.partial(dist_graph.optimize, mesh=mesh, sep_capacity=sep_capacity)
    solves = captured.CapturedSolves(dev)
    out = {}
    for solver in ("direct", "pcg", "schur"):
        rep, rep_stats = pg.optimize(nodes, edges, mask, linear_solver=solver,
                                     schur_chunk_size=solvers["chunk"],
                                     schur_sep_capacity=sep_capacity, **kw)
        eager = functools.partial(pg.solve_bucket, nodes, edges, mask, K, solver,
                                  optimize_fn=dist_fn, **kw)
        got, stats = eager()
        dist = float(torch.linalg.norm(got.t - rep.t, dim=-1).max())
        cost_rel = abs(float(stats.final_cost) - float(rep_stats.final_cost)) / max(
            abs(float(rep_stats.final_cost)), 1e-30)
        r = out[f"dist-{solver}"] = {
            "eager_ms": _timed(eager, iters=5, warmup=1), "replicated_ms": solvers[solver]["ms"],
            "initial_cost": float(stats.initial_cost), "final_cost": float(stats.final_cost),
            "replicated_final_cost": float(rep_stats.final_cost), "cost_rel": cost_rel,
            "max_dist_to_replicated_m": dist, "replay_ms": None}
        extra = ""
        if solver == "schur":
            r.update(n_sep=n_sep, chunk=chunk, fell_back=n_sep > sep_capacity)
            extra = (f"; {n_sep} separators at chunk {chunk} for {sep_capacity} slots, "
                     f"{'fell back to direct' if r['fell_back'] else 'no fallback'}; not "
                     "captured (ok is read on the host)")
        else:
            def replay(s=solver):
                return solves.full(nodes, edges, mask, K, s, mesh=mesh, **kw)

            g = replay()
            torch.cuda.synchronize()
            r["replay_ms"] = _timed(replay, iters=5, warmup=1)
            r["replay_dist_to_eager_m"] = float(torch.linalg.norm(g[0].t - got.t, dim=-1).max())
            extra = (f"; captured replay {r['replay_ms']:.3f} ms, "
                     f"{r['replay_dist_to_eager_m']:.3g} m from eager")
            if not r["replay_dist_to_eager_m"] <= CAPTURED_DIST:
                raise AssertionError(f"captured dist-{solver}: {r['replay_dist_to_eager_m']} m "
                                     f"from eager (> {CAPTURED_DIST})")
        print(f"[21] dist-{solver} over {SHARDS} shards on {int(store.count)} nodes: eager "
              f"{r['eager_ms']:.2f} ms (replicated {solver}, phase 10: {r['replicated_ms']:.2f}); "
              f"cost {r['initial_cost']:.6g} -> {r['final_cost']:.6g} (replicated "
              f"{r['replicated_final_cost']:.6g}, {cost_rel:.3g} rel); {dist:.3g} m from the "
              f"replicated solve{extra}")
        if not (torch.isfinite(got.t).all() and torch.isfinite(got.q).all()):
            raise AssertionError(f"dist-{solver}: non-finite poses")
        if not (dist <= SOLVER_DIST and cost_rel <= DIST_COST_REL):
            raise AssertionError(f"dist-{solver}: {dist} m and {cost_rel} rel cost from the "
                                 f"replicated solve (> {SOLVER_DIST} / {DIST_COST_REL})")
    out["graphs"] = len(solves.graphs)

    n = SLICE_SCANS
    runs = {}
    for solver in ("direct", "dist-schur"):
        cfg = kitti_config(graph_incremental=False, graph_linear_solver=solver)
        calls = dist_graph.optimize.calls
        s, launches, _, res = _drive(runner.kitti_proxy_source, cfg, n, dev, mesh=mesh)
        runs[solver] = (s, res.records, dist_graph.optimize.calls - calls)
    (s_r, rec_r, _), (s_d, rec_d, dist_calls) = runs["direct"], runs["dist-schur"]
    dist = float(np.linalg.norm(rec_d[:, :3] - rec_r[:, :3], axis=-1).max())
    print(f"[21] slice with graph_incremental=False, dist-schur against direct: {dist:.3g} m "
          f"apart; {s_d['optimizations']} optimizations ({s_r['optimizations']}), "
          f"{dist_calls} distributed solves; ms/scan median {s_d['step_ms_p50']:.2f} "
          f"({s_r['step_ms_p50']:.2f}; phase 5: {slice_summary['step_ms_p50']:.2f})")
    if not (dist <= DIST_SCHUR_DIST and s_d["optimizations"] == s_r["optimizations"] >= 1
            and dist_calls == s_d["optimizations"]):
        raise AssertionError(f"dist-schur slice: {dist} m from direct (> {DIST_SCHUR_DIST}), "
                             f"{s_d['optimizations']} / {s_r['optimizations']} optimizations, "
                             f"{dist_calls} distributed solves")
    out["slice"] = {"max_dist_m": dist, "optimizations": s_d["optimizations"],
                    "ms_p50": s_d["step_ms_p50"], "direct_ms_p50": s_r["step_ms_p50"]}
    return out


def phase_batched(dev, query_world, map_pts, fill):
    """Phase 22: the batched multi-shard step (the path of JAX's
    ``dryrun_multichip``) at the port's widths, and ``sharded_nn`` against
    one K1 call on a map-sized target."""
    import numpy as np
    import torch

    from icpslam_tpu_torch.cloud import pointcloud as pc
    from icpslam_tpu_torch.cloud.voxel import voxel_downsample
    from icpslam_tpu_torch.config import kitti_config
    from icpslam_tpu_torch.eval import metrics
    from icpslam_tpu_torch.geometry import se3
    from icpslam_tpu_torch.geometry.se3 import Pose
    from icpslam_tpu_torch.io import runner
    from icpslam_tpu_torch.ops import nn
    from icpslam_tpu_torch.parallel import dist_graph, dist_step, sharded_nn
    from icpslam_tpu_torch.parallel import mesh as mesh_lib

    cfg = kitti_config()
    B = BATCH_PAIRS
    stream, gt = runner.kitti_proxy_source(cfg, B + 1, 10.0)
    clouds = []
    for (pts, mask), _ in stream:
        raw = pc.PointCloud(torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev))
        clouds.append(voxel_downsample(raw, cfg.voxel_leaf_size, cfg.max_points)[0])
    src = pc.PointCloud(torch.stack([c.points for c in clouds[1:]]),
                        torch.stack([c.mask for c in clouds[1:]]))
    tgt = pc.PointCloud(torch.stack([c.points for c in clouds[:-1]]),
                        torch.stack([c.mask for c in clouds[:-1]]))
    mesh = mesh_lib.make_mesh(SHARDS, device=dev)
    icfg = cfg.icp_odometry

    # K1 launches per registered pair, read around each registration
    register, per_pair = dist_step._register, []

    def counted(s, t, c):
        k0 = nn.nn1_cuda.launches
        res = register(s, t, c)
        per_pair.append(nn.nn1_cuda.launches - k0)
        return res

    for fn in runner.KERNELS.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist_step._register = counted
    try:
        result, smap, nnres = dist_step.batched_slam_step_with_map(
            src, tgt, icfg, mesh, map_resolution=cfg.map_resolution,
            map_capacity_per_shard=cfg.max_map_points)
        torch.cuda.synchronize()
    finally:
        dist_step._register = register
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = {name: fn.launches for name, fn in runner.KERNELS.items()}
    gt_pose = Pose(torch.from_numpy(gt[0][: B + 1]), torch.from_numpy(gt[1][: B + 1]))
    ate, _ = metrics.ate(Pose(result.nodes.t.cpu(), result.nodes.q.cpu()), gt_pose, align=True)
    ate = float(ate)
    sizes = smap.size.cpu().numpy()

    # the same graph through dist-pcg and dist-schur (K = B + 1 = 16 nodes)
    nodes0 = dist_step.chain_poses(result.rel_poses, se3.identity(device=dev))
    edges = dist_step.sequential_edges(result.rel_poses)
    node_mask = torch.ones((B + 1,), dtype=torch.bool, device=dev)
    other = {}
    for solver in ("pcg", "schur"):
        opt, st = dist_graph.optimize(nodes0, edges, node_mask, mesh, iterations=5, mode="gn",
                                      linear_solver=solver)
        other[solver] = float(torch.linalg.norm(opt.t - result.nodes.t, dim=-1).max())
    print(f"[22] batched step, {B} pairs over {SHARDS} shards ({int(src.mask[0].sum())} of "
          f"{cfg.max_points} points in the first scan): {step_ms:.1f} ms with the map; ATE "
          f"{ate:.4f} m; cost {float(result.final_cost):.6g}; K1 launches per pair "
          f"{per_pair} ({launches['nn1']} in all), K2 {launches['knn']}; map {int(sizes.sum())} "
          f"voxels in shards {sizes.tolist()}, NN found {int(nnres.found.sum())} of "
          f"{int(src.mask[0].sum())}; dist-pcg and dist-schur {other['pcg']:.3g} / "
          f"{other['schur']:.3g} m from dist-direct")
    finite = all(bool(torch.isfinite(x).all()) for x in (*result.nodes, *result.rel_poses))
    if not (finite and np.isfinite(float(result.final_cost))):
        raise AssertionError("batched step: non-finite poses or cost")
    if len(per_pair) != B or min(per_pair) < 1:
        raise AssertionError(f"batched step: K1 not launched on every pair: {per_pair}")
    if launches["knn"] < 2 * B:
        raise AssertionError(f"batched step: K2 launched {launches['knn']} times for {B} pairs")
    if not ate <= BATCH_ATE:
        raise AssertionError(f"batched step ATE {ate} > {BATCH_ATE} m")
    if not (sizes.sum() > 0 and bool(nnres.found.any())):
        raise AssertionError("batched step: the sharded map stayed empty or found nothing")
    if not max(other.values()) <= SOLVER_DIST:
        raise AssertionError(f"batched step: dist-pcg / dist-schur {other} m from dist-direct")

    # sharded_nn on the map-sized target against one K1 call on all the
    # queries. K1 centres the coordinates on its queries' centroid, and each
    # shard's block has its own, so d² may differ in the last bits: each
    # block equals K1 on that block bit for bit, and against the one call
    # the d² agree within MOM_ABS + MOM_REL·d², and where an index differs
    # the float64 distances of the two targets agree within that bound too
    # (a tie to float32 rounding)
    q = query_world.points.contiguous()
    m = torch.arange(map_pts.shape[0], device=dev) < fill
    k0 = nn.nn1_cuda.launches
    got = sharded_nn.nearest_neighbors(q, map_pts, m, mesh)
    shard_launches = nn.nn1_cuda.launches - k0
    want = nn.nearest_neighbors(q, map_pts, m)
    per = q.shape[0] // SHARDS
    for b in range(SHARDS):
        blk = nn.nearest_neighbors(q[b * per:(b + 1) * per], map_pts, m)
        _equal(f"sharded_nn block {b}", got.idx[b * per:(b + 1) * per],
               got.dist2[b * per:(b + 1) * per], blk.idx, blk.dist2)
    torch.cuda.synchronize()
    err = _close("sharded_nn d2 against one K1 call", got.dist2, want.dist2)
    bits = int((got.dist2.view(torch.int32) != want.dist2.view(torch.int32)).sum())
    moved = got.idx != want.idx

    def d64(idx):
        return ((q.double() - map_pts[idx].double()) ** 2).sum(-1)

    tie = _close("sharded_nn: the targets where an index differs", d64(got.idx[moved])
                 if moved.any() else torch.zeros(0, dtype=torch.float64, device=dev),
                 d64(want.idx[moved]) if moved.any() else torch.zeros(0, dtype=torch.float64,
                                                                     device=dev))
    print(f"[22] sharded_nn over {SHARDS} shards, {q.shape[0]} x {map_pts.shape[0]} at {fill} "
          f"fill: {shard_launches} K1 launches, every block equal to K1 on that block bit for "
          f"bit; against one K1 call on all queries: {bits} d2 differ in their bits (max "
          f"|diff| {err:.3g}), {int(moved.sum())} indices differ (float64 gap {tie:.3g})")
    if shard_launches != SHARDS:
        raise AssertionError(f"sharded_nn launched K1 {shard_launches} times, not {SHARDS}")
    return {"pairs": B, "step_ms": step_ms, "ate_m": ate, "launches": launches,
            "k1_per_pair": per_pair, "map_size": int(sizes.sum()), "shard_sizes": sizes.tolist(),
            "nn_found": int(nnres.found.sum()), "dist_to_direct_m": other,
            "sharded_nn_max_abs_err": err, "sharded_nn_d2_bits_differ": bits,
            "sharded_nn_idx_differ": int(moved.sum())}


def phase_nccl(dev, state, sharded_records):
    """Phase 23: a NCCL process group of one rank, so that the mesh's
    collectives run through ``dist.all_reduce`` / ``all_gather_into_tensor``
    on the card: phase 20's SHARDS-shard drive and phase 21's dist-direct
    solve on that mesh, against the mesh without a group."""
    import datetime
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from icpslam_tpu_torch.config import kitti_config
    from icpslam_tpu_torch.io import runner
    from icpslam_tpu_torch.parallel import dist_graph, sharded_nn
    from icpslam_tpu_torch.parallel import mesh as mesh_lib

    store_dir = tempfile.mkdtemp(prefix="_nccl_store_", dir=os.path.dirname(os.path.abspath(__file__)))
    calls = {"all_reduce": 0, "all_gather_into_tensor": 0}
    originals = {name: getattr(dist, name) for name in calls}

    def counting(name):
        def call(*a, **k):
            calls[name] += 1
            return originals[name](*a, **k)
        return call

    try:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(store_dir, "store"), 1),
                                world_size=1, rank=0, timeout=datetime.timedelta(seconds=120))
        for name in calls:
            setattr(dist, name, counting(name))
        try:
            mesh = mesh_lib.make_mesh(SHARDS, device=dev)
            plain = mesh_lib.Mesh(size=SHARDS, group=None, world=1, rank=0, device=mesh.device)
            if mesh.group is None or mesh.world != 1:
                raise AssertionError(f"expected a group of one rank: {mesh}")
            cfg = kitti_config(map_backend="sharded", map_shards=SHARDS)
            s, launches, _, res = _drive(runner.kitti_proxy_source, cfg, SLICE_SCANS, dev,
                                         mesh=mesh)
            drive_calls = dict(calls)
            equal = bool(np.array_equal(res.records, sharded_records))
            store, edges = state.keyframes, state.edges
            args = (store.pose_graph, edges, store.valid_mask())
            kw = dict(iterations=3, mode="lm", linear_solver="direct")
            got, _ = dist_graph.optimize(*args, mesh, **kw)
            want, _ = dist_graph.optimize(*args, plain, **kw)
            solve_dist = float(torch.linalg.norm(got.t - want.t, dim=-1).max())
            q = res.state.keyframes.points[0]
            a = sharded_nn.nearest_neighbors(q, store.points[1], store.point_mask[1], mesh)
            b = sharded_nn.nearest_neighbors(q, store.points[1], store.point_mask[1], plain)
            torch.cuda.synchronize()
            _equal("sharded_nn under NCCL", a.idx, a.dist2, b.idx, b.dist2)
        finally:
            for name, fn in originals.items():
                setattr(dist, name, fn)
            dist.destroy_process_group()
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    print(f"[23] NCCL, world size 1, {SHARDS} shards: the drive's records equal phase 20's bit "
          f"for bit: {equal} ({drive_calls['all_reduce']} all_reduce calls, ms/scan median "
          f"{s['step_ms_p50']:.2f}); dist-direct {solve_dist:.3g} m from the mesh without a "
          f"group; sharded_nn equal; collectives {calls}")
    if not equal:
        raise AssertionError("NCCL mesh: records differ from the mesh without a group")
    if not solve_dist <= NCCL_DIST:
        raise AssertionError(f"NCCL mesh: dist-direct {solve_dist} m from the plain mesh's")
    if not (drive_calls["all_reduce"] > 0 and calls["all_gather_into_tensor"] > 0):
        raise AssertionError(f"NCCL mesh: the collectives did not go through the group: {calls}")
    return {"records_equal": equal, "solve_dist_m": solve_dist, "collective_calls": calls,
            "ms_p50": s["step_ms_p50"], "launches": launches}


# ---------------------------------------------------------------------------
# phases 24-29: the tools of icpslam_tpu_torch/tools/ and examples/, each
# run as a user runs it (python -m ..., a subprocess with a time limit),
# its artifact or summary read back; a tool's kernel launches are counted
# in its own processes (from 0 at their start) and reported in the artifact
# ---------------------------------------------------------------------------

# the runner's scan-cache tag of the physics render (no INS de-skew)
CACHE_TAG = 1
ENDURANCE_KEYS = ("metric", "scans", "full_run", "half_run", "resumed_run", "resume_equivalence",
                  "late_mission_scans_per_sec", "capacity_exhaustion_run",
                  "capacity_exhaustion_frozen", "deferred_backend_run")
SHARDED_KEYS = ("metric", "backend", "sharded", "single_device", "parity_ate_delta_m", "note")
# tools/sharded_endurance.py: both drives within SHARDED_END_ATE, and
# within SHARDED_END_DELTA of each other (JAX recorded 0.0985 and 0.0994 m
# over 500 scans on the CPU, artifacts/sharded_endurance.json)
SHARDED_END_ATE = 0.15
SHARDED_END_DELTA = 0.02
# JAX's examples/synthetic_city.py --cpu at its defaults (120 poses) gives
# ATE 0.0303 m (20 loop-closure edges, 120 keyframes) on the CPU;
# the port's run on the card within max(CITY_ATE_FLOOR, 1.5 x this)
JAX_CITY_ATE = 0.0303
CITY_ATE_FLOOR = 0.10


def _tool(tag: str, module: str, args, timeout: float, check: bool = True):
    """Run ``python -m module *args`` from the checkout's root in a
    process group of its own (in the script's session), which is killed
    whole when it ends or passes ``timeout``: (stdout, stderr, seconds, exit
    code); with ``check`` a non-zero exit raises."""
    import os
    import signal

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", module, *args], cwd=here,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            process_group=0)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        if proc.poll() is None:
            proc.wait()
    secs = time.perf_counter() - t0
    if check and proc.returncode != 0:
        raise AssertionError(f"[{tag}] {module} exited {proc.returncode}:\n{stderr[-3000:]}")
    return stdout, stderr, secs, proc.returncode


def _json_lines(out: str):
    return [json.loads(l) for l in out.splitlines() if l.startswith("{")]


def _run_line(tag: str, s: dict) -> str:
    n = s["scans"]
    ate = f"ATE {s['ate_m']:.4f} m" if "ate_m" in s else "no ATE"
    return (f"[24] {tag}: {n} scans, {ate}, {s['keyframes']} keyframes, "
            f"{s['keyframe_evictions']} evictions, {s['loop_closures']} loop-closure edges, "
            f"{s['optimizations']} solves ({s['pcg_solves']} PCG); ms/scan median "
            f"{s['step_ms_p50']:.2f} p90 {s['step_ms_p90']:.2f} max {s['step_ms_max']:.2f}; "
            f"first step {s['compile_ms']:.0f} ms; host syncs/scan "
            f"{s['host_syncs_per_scan']:.2f}; launches/scan K1 {s['nn1_launches_per_scan']:.2f} "
            f"K2 {s['knn_launches_per_scan']:.2f}; peak memory "
            f"{s['peak_memory_bytes'] / 2**20:.1f} MiB; wall {s['_invocation_wall_s']} s")


def _check_registered_launches(tag: str, s: dict) -> None:
    missed = s["registered_scans_without_launch"]
    if missed["nn1"] or missed["knn"] or not s["nn1_launches_per_scan"] > 0:
        raise AssertionError(f"{tag}: K1/K2 not launched in every registered scan: {missed}")


def _write_cache(rendered, work: str) -> str:
    """The first ENDURANCE_SCANS of phase 13's scans as the runner's scan
    cache (tag 1) in ``work``."""
    import os

    import numpy as np

    scans, gt = rendered
    n = ENDURANCE_SCANS
    cache = os.path.join(work, "proxy.npz")
    np.savez(cache, gt_t=gt[0][:n], gt_q=gt[1][:n], tag=CACHE_TAG,
             **{f"s{i}": p[m] for i, ((p, m), _) in enumerate(scans[:n])})
    return cache


def phase_endurance(dev, cache: str, physics: dict, work: str):
    """Phase 24: ``tools/endurance`` over the scan cache."""
    import os

    n = ENDURANCE_SCANS
    out = os.path.join(work, "endurance.json")
    _, _, secs, _ = _tool("24", "icpslam_tpu_torch.tools.endurance",
                          ["--scans", str(n), "--cache", cache, "--out", out, "--device", str(dev)],
                          timeout=900)
    with open(out) as f:
        art = json.load(f)
    missing = [k for k in ENDURANCE_KEYS if k not in art]
    if missing or "name" not in art.get("card", {}):
        raise AssertionError(f"endurance artifact: missing {missing}, card {art.get('card')}")
    runs = {"A": art["full_run"], "B1": art["half_run"], "B2": art["resumed_run"],
            "C": art["capacity_exhaustion_run"], "C_frozen": art["capacity_exhaustion_frozen"],
            "D": art["deferred_backend_run"]}
    p13 = physics["physics"]
    print(f"[24] endurance, {n} scans, six runner processes in {secs:.1f} s; card "
          f"{art['card']['name']}, {art['card']['power_limit']}; phase 13 (500 scans, one "
          f"process): ms/scan {_fmt(p13['ms'])}, peak memory "
          f"{p13['peak_bytes'] / 2**20:.1f} MiB")
    for tag, s in runs.items():
        print(_run_line(tag, s))
        if not s["poses_finite"]:
            raise AssertionError(f"endurance {tag}: non-finite poses")
        _check_registered_launches(f"endurance {tag}", s)
    for tag in ("A", "B2", "D"):
        if not runs[tag]["ate_m"] <= PHYSICS_ATE:
            raise AssertionError(f"endurance {tag}: ATE {runs[tag]['ate_m']} > {PHYSICS_ATE} m")
    eq = art["resume_equivalence"]
    print(f"[24] resume: end gap {eq['end_gap_m']:.4f} m, tail RMSE {eq['tail_rmse_m']:.4f} m "
          f"(B2 resumed {runs['B2']['resumed_keyframes']} keyframes); late-mission "
          f"{art['late_mission_scans_per_sec']:.2f} scans/s; D launched "
          f"{runs['D']['deferred_launched']}, folded {runs['D']['deferred_folded']}")
    if not (eq["end_gap_m"] <= PHYSICS_ATE and eq["tail_rmse_m"] <= PHYSICS_ATE):
        raise AssertionError(f"endurance resume: {eq}")
    if runs["D"]["deferred_launched"] != runs["D"]["deferred_folded"]:
        raise AssertionError("endurance D: deferred solves launched and folded differ")
    c = runs["C"]
    print(f"[24] C at {n} scans: {c['keyframes']} of 512 keyframes, "
          f"{c['keyframe_evictions']} evictions"
          + ("; the store does not fill this short: the full-length run (2,000 scans) shows "
             "the eviction" if c["keyframes"] < 512 else ""))
    return art


def phase_tree_run(dev, work: str, cache: str):
    """Phase 25: ``tools/kitti_tree_run`` on phase 24's cache; the tree is
    written inside ``work`` (removed afterwards)."""
    import os

    _, _, secs, _ = _tool("25", "icpslam_tpu_torch.tools.kitti_tree_run",
                          ["--cache", cache, "--scans", str(ENDURANCE_SCANS), "--root",
                           os.path.join(work, "tree"), "--out", os.path.join(work, "tree.json"),
                           "--device", str(dev)], timeout=600)
    with open(os.path.join(work, "tree.json")) as f:
        s = json.load(f)
    print(f"[25] KITTI tree, {s['scans']} scans, in {secs:.1f} s: ATE {s['ate_m']:.4f} m, "
          f"accepted {s['accepted']}, {s['keyframes']} keyframes; ms/scan median "
          f"{s['step_ms_p50']:.2f} p90 {s['step_ms_p90']:.2f}; launches/scan K1 "
          f"{s['nn1_launches_per_scan']:.2f} K2 {s['knn_launches_per_scan']:.2f}; loader "
          f"{s['loader']}; peak memory {s['peak_memory_bytes'] / 2**20:.1f} MiB")
    if s["loader"] != "native":
        raise AssertionError(f"tree run: loader {s['loader']}")
    if not s["ate_m"] <= PHYSICS_ATE:
        raise AssertionError(f"tree run: ATE {s['ate_m']} > {PHYSICS_ATE} m")
    if not s["poses_finite"]:
        raise AssertionError("tree run: non-finite poses")
    _check_registered_launches("tree run", s)
    return s


def phase_sharded_endurance(dev, work: str):
    """Phase 26: ``tools/sharded_endurance`` over SHARDED_SCANS scans, 8
    shards on the card with no process group, and its voxel twin."""
    import os

    _, _, secs, _ = _tool("26", "icpslam_tpu_torch.tools.sharded_endurance",
                          ["--scans", str(SHARDED_SCANS), "--out", os.path.join(work, "sharded.json"),
                           "--device", str(dev)], timeout=600)
    with open(os.path.join(work, "sharded.json")) as f:
        art = json.load(f)
    missing = [k for k in SHARDED_KEYS if k not in art]
    if missing:
        raise AssertionError(f"sharded endurance artifact: missing {missing}")
    rs, rv, per = art["sharded"], art["single_device"], art["sharded"]["per_shard"]
    for tag, r in (("sharded", rs), ("voxel", rv)):
        print(f"[26] {tag}: {r['scans']} scans in {r['wall_s']} s ({1e3 * r['wall_s'] / r['scans']:.2f}"
              f" ms/scan), ATE {r['ate_m']:.4f} m, {r['keyframes']} keyframes, "
              f"{r['keyframe_evictions']} evictions, {r['loop_closures']} loop-closure edges, "
              f"{r['optimizations']} solves, map {r['map_size']} (overflow {r['map_overflow']}); "
              f"launches K1 {r['launches']['nn1']} K2 {r['launches']['knn']}")
        if not r["poses_finite"]:
            raise AssertionError(f"sharded endurance {tag}: non-finite poses")
        if not r["ate_m"] <= SHARDED_END_ATE:
            raise AssertionError(f"sharded endurance {tag}: ATE {r['ate_m']} > {SHARDED_END_ATE}")
        if not (r["launches"]["nn1"] > 0 and r["launches"]["knn"] > 0):
            raise AssertionError(f"sharded endurance {tag}: launches {r['launches']}")
    print(f"[26] per shard: sizes {per['sizes']}, overflow {per['overflow']}; |dATE| "
          f"{art['parity_ate_delta_m']:.4f} m; {secs:.1f} s in all")
    if len(per["sizes"]) != 8 or not max(per["overflow"]) > 0:
        raise AssertionError(f"sharded endurance: no shard overflowed: {per}")
    if not (rs["keyframe_evictions"] > 0 and rs["optimizations"] > 0):
        raise AssertionError("sharded endurance: no eviction or no solve")
    if not art["parity_ate_delta_m"] <= SHARDED_END_DELTA:
        raise AssertionError(f"sharded endurance: |dATE| {art['parity_ate_delta_m']} m")
    return art


def phase_probes(dev):
    """Phase 27: ``tools/probe_step_budget`` and ``tools/probe_scan_to_map``
    at the JAX probes' configuration."""
    import math

    out, _, secs, _ = _tool("27", "icpslam_tpu_torch.tools.probe_step_budget",
                            ["--device", str(dev)], timeout=600)
    budget = [l for l in _json_lines(out) if "ms_per_scan" in l]
    full = budget[0]["ms_per_scan"]
    for l in budget:
        print(f"[27] step budget {l['variant']:>20}: {l['ms_per_scan']:.2f} ms/scan (spread "
              f"{l['spread'][0]:.2f}-{l['spread'][1]:.2f}; {l['ms_per_scan'] - full:+.2f} against "
              f"full), host syncs/scan {l['host_syncs_per_scan']:.2f}, K1 "
              f"{l['k1_launches_per_scan']:.2f} K2 {l['k2_launches_per_scan']:.2f} per scan")
        if not all(math.isfinite(x) for x in [l["ms_per_scan"], *l["spread"]]):
            raise AssertionError(f"step budget: {l}")
    if len(budget) != 7 or not budget[0]["k1_launches_per_scan"] > 0:
        raise AssertionError(f"step budget: {budget}")
    out, _, secs2, _ = _tool("27", "icpslam_tpu_torch.tools.probe_scan_to_map",
                             ["--device", str(dev)], timeout=600)
    knobs = [l for l in _json_lines(out) if "probe" in l]
    for l in knobs:
        print(f"[27] scan-to-map {l['probe']:>15}: {l['ms']:.2f} ms/call, iterations "
              f"{l['iters']}, map fill {l['map_fill']}, host syncs/call "
              f"{l['host_syncs_per_call']:.2f}, K1 {l['k1_launches_per_call']:.2f} per call")
        if not (math.isfinite(l["ms"]) and all(1 <= i <= l["max_iterations"] for i in l["iters"])):
            raise AssertionError(f"scan-to-map probe: {l}")
    if len(knobs) != 6:
        raise AssertionError(f"scan-to-map probe: {knobs}")
    print(f"[27] probes in {secs:.1f} s and {secs2:.1f} s")
    return {"step_budget": budget, "scan_to_map": knobs}


def phase_dcn_refusal(work: str) -> dict:
    """Phase 28, first half: ``tools.scaling_dcn`` and ``tools.elastic_dcn
    --device cuda``; on one card each must exit non-zero within 10 s,
    naming the card count, before spawning a rank. With two cards or more
    both run on the cards."""
    import os

    import torch

    from icpslam_tpu_torch.tools import _dcn

    cards = torch.cuda.device_count()
    out = {"cards": cards}
    for name in ("scaling_dcn", "elastic_dcn"):
        art = os.path.join(work, f"{name}.json")
        stdout, stderr, secs, code = _tool("28", f"icpslam_tpu_torch.tools.{name}",
                                           ["--device", "cuda", "--out", art], timeout=900,
                                           check=cards >= _dcn.RANKS)
        if cards < _dcn.RANKS:
            said = stderr.strip().splitlines()[-1] if stderr.strip() else ""
            print(f"[28] {name} --device cuda on {cards} card: exit {code} in {secs:.1f} s: {said}")
            if code == 0 or secs > 10 or f"has {cards}" not in said:
                raise AssertionError(f"{name} did not refuse one card: {stderr[-2000:]}")
            if "proc0" in stdout or os.path.exists(art):
                raise AssertionError(f"{name} spawned a rank on one card")
        else:
            with open(art) as f:
                out[name] = json.load(f)
            print(f"[28] {name} on {cards} cards in {secs:.1f} s: {out[name]}")
    return out


def phase_dcn_single(dev) -> dict:
    """Phase 28, second half: the degraded workload
    (``elastic_dcn.run_single``) on the card, D = 4 shards in one process."""
    from icpslam_tpu_torch.io import runner
    from icpslam_tpu_torch.tools import _dcn, elastic_dcn

    for fn in runner.KERNELS.values():
        fn.launches = 0
    res = elastic_dcn.run_single(str(dev))
    launches = {k: fn.launches for k, fn in runner.KERNELS.items()}
    calls = 7 * _dcn.PAIRS   # one warm call and six timed, each registering every pair
    print(f"[28] run_single on {dev}: {res['shards']} shards, {res['pairs']} pairs, step "
          f"{res['step_ms']:.2f} ms; launches K1 {launches['nn1']} ({launches['nn1'] / calls:.2f}"
          f" per pair), K2 {launches['knn']}")
    if not res["poses_finite"]:
        raise AssertionError("run_single: non-finite poses")
    if launches["nn1"] < calls or launches["knn"] < 2 * calls:
        raise AssertionError(f"run_single: K1/K2 not launched on every pair: {launches}")
    return {"run_single": res, "launches": launches}


def phase_examples(dev, work: str):
    """Phase 29: ``examples/synthetic_city`` at its defaults with every
    export read back, and ``examples/sharded_streaming`` over 8 shards."""
    import os

    import numpy as np

    from icpslam_tpu_torch.examples import synthetic_city
    from icpslam_tpu_torch.pipeline import slam
    from icpslam_tpu_torch.utils import checkpoint

    d = os.path.join(work, "city")
    out, _, secs, _ = _tool("29", "icpslam_tpu_torch.examples.synthetic_city",
                            ["--out-dir", d], timeout=600)
    s = _json_lines(out)[-1]
    limit = max(CITY_ATE_FLOOR, 1.5 * JAX_CITY_ATE)
    with open(os.path.join(d, "trajectory.txt")) as f:
        tum = sum(1 for _ in f)
    with open(os.path.join(d, "map.ply"), "rb") as f:
        head = f.read(200).split(b"end_header")[0].decode()
    ply = int(head.split("element vertex ")[1].split()[0])
    with open(os.path.join(d, "graph.json")) as f:
        graph = json.load(f)
    state = checkpoint.load(os.path.join(d, "state.npz"),
                            slam.init_state(synthetic_city.config(), device=dev))
    with open(os.path.join(d, "viewer.html")) as f:
        viewer = "const DATA = {" in f.read()
    print(f"[29] synthetic_city, {s['scans']} scans in {secs:.1f} s: ATE {s['ate_m']:.4f} m "
          f"(JAX on the CPU {JAX_CITY_ATE} m; limit {limit:.4f}), {s['keyframes']} keyframes, "
          f"{s['loop_closures']} loop-closure edges, {s['optimizations']} solves; exports: TUM "
          f"{tum} lines, PLY {ply} points, graph {len(graph['nodes'])} nodes, checkpoint "
          f"{int(state.keyframes.count)} keyframes, viewer {viewer}; launches K1 "
          f"{s['launches']['nn1']} K2 {s['launches']['knn']}")
    if not s["loop_closures"] >= 1:
        raise AssertionError("synthetic_city: no loop closure")
    if not (tum == s["scans"] and ply > 0 and ply == s["map_points"]
            and len(graph["nodes"]) == s["keyframes"] == int(state.keyframes.count) and viewer):
        raise AssertionError("synthetic_city: an export does not read back")
    if not s["ate_m"] <= limit:
        raise AssertionError(f"synthetic_city: ATE {s['ate_m']} > {limit} m")
    out2, _, secs2, _ = _tool("29", "icpslam_tpu_torch.examples.sharded_streaming",
                              ["--poses", "16", "--devices", "8", "--device", str(dev)],
                              timeout=300)
    r = _json_lines(out2)[-1]
    peak = r["peak_map_voxels_per_shard"]
    print(f"[29] sharded_streaming, {r['scans']} scans over {r['devices']} shards in "
          f"{secs2:.1f} s: ATE {r['ate_m']:.4f} m, {r['keyframes']} keyframes, voxels at the end "
          f"{r['map_voxels_per_shard']} = {r['map_voxels_total']}, at the largest (step "
          f"{r['peak_map_step']}) {peak} = {r['peak_map_voxels_total']}; launches K1 "
          f"{r['launches']['nn1']} K2 {r['launches']['knn']}")
    if not (np.isfinite(r["ate_m"]) and sum(r["map_voxels_per_shard"]) == r["map_voxels_total"]
            and len(r["map_voxels_per_shard"]) == len(peak) == 8
            and r["peak_map_voxels_total"] > 0 and sum(peak) == r["peak_map_voxels_total"]
            and sum(1 for v in peak if v > 0) > 1):
        raise AssertionError(f"sharded_streaming: {r}")
    if not (r["launches"]["nn1"] > 0 and r["launches"]["knn"] > 0):
        raise AssertionError(f"sharded_streaming: K1/K2 not launched: {r['launches']}")
    return {"synthetic_city": s, "sharded_streaming": r}


def _tool_launches(tool_runs: dict):
    """(field, launches by kernel, path) of each tool phase for the
    kernels line: the counts its processes reported."""
    def from_summary(s):
        return {k: round(s[f"{k}_launches_per_scan"] * s["scans"])
                for k in ("nn1", "knn", "radius", "nn1_matmul")}

    end, tree = tool_runs["endurance"], tool_runs["tree"]
    sharded = tool_runs["sharded_endurance"]["sharded"]
    full = tool_runs["probes"]["step_budget"][0]
    budget_scans = 3 * 30   # three passes over the 30 timed scans
    return [
        ("endurance", from_summary(end["full_run"]),
         f"tools.endurance run A, {end['scans']} scans (phase 24)"),
        ("tree_run", from_summary(tree), f"tools.kitti_tree_run, {tree['scans']} scans (phase 25)"),
        ("sharded_endurance", sharded["launches"],
         f"tools.sharded_endurance over 8 shards, {sharded['scans']} scans (phase 26)"),
        ("step_budget", {"nn1": round(full["k1_launches_per_scan"] * budget_scans),
                         "knn": round(full["k2_launches_per_scan"] * budget_scans)},
         "tools.probe_step_budget 'full', 3 x 30 scans (phase 27)"),
        ("dcn_single", tool_runs["dcn"]["launches"],
         "tools.elastic_dcn.run_single, 7 calls of 4 pairs (phase 28)"),
        ("synthetic_city", tool_runs["examples"]["synthetic_city"]["launches"],
         f"examples.synthetic_city, {tool_runs['examples']['synthetic_city']['scans']} scans "
         "(phase 29)"),
    ]


def phase_tools_beside(dev, rendered, physics: dict, work: str):
    """Phases 24-25, one after another, on the thread of phase 26, beside
    phases 16-23: each runs the tool in subprocesses and reads its artifact
    back, and touches neither this process's CUDA state nor its launch
    counts."""
    t0 = time.perf_counter()
    cache = _write_cache(rendered, work)
    out = {"endurance": phase_endurance(dev, cache, physics, work),
           "tree": phase_tree_run(dev, work, cache)}
    out["beside_seconds"] = time.perf_counter() - t0
    print(f"    phases 24-25 in {out['beside_seconds']:.1f} s, beside phases 16-23")
    return out


def phase_tools(dev, sharded_endurance, beside, work: str):
    """Phases 27-29, one after another, once phases 24-26 (the futures
    ``sharded_endurance`` of phase 26 and ``beside`` of
    ``phase_tools_beside``) are done: phase 27 times steps and phase 28 a
    refusal, so nothing runs beside them."""
    t0 = time.perf_counter()
    out = beside.result()
    out["sharded_endurance"] = sharded_endurance.result()
    waited = time.perf_counter() - t0
    out["probes"] = phase_probes(dev)
    out["dcn"] = phase_dcn_refusal(work)
    out["dcn"].update(phase_dcn_single(dev))
    out["examples"] = phase_examples(dev, work)
    out["seconds"] = time.perf_counter() - t0
    print(f"    phases 27-29 in {out['seconds'] - waited:.1f} s, after {waited:.1f} s waiting "
          "for phases 24-26")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write all results to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this needs a GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    card = phase_device_and_build()
    clouds, query_world, map_pts, fill = _main_path_clouds(dev)
    print(f"    main-path clouds: {[int(c.mask.sum()) for c in clouds]} live of 8192; map fill {fill}")
    k1_err, k1 = phase_k1(clouds, query_world, map_pts, fill, dev)
    k2_err, k2 = phase_k2(clouds, dev)
    sentinel = phase_sentinel(dev)
    slice_summary, slice_launches, slice_records = phase_slice(dev)
    from icpslam_tpu_torch.config import kitti_config
    from icpslam_tpu_torch.io import runner

    # phase 5's scans, rendered once for phases 30 and 12
    slice_scans = _render(runner.kitti_proxy_source, kitti_config(), SLICE_SCANS)
    k3_err, k3 = phase_k3(clouds, dev)
    k4_err, k4_times = phase_k4(clouds, query_world, map_pts, fill, dev)
    mission, mission_launches = phase_mission(dev)
    rendered = _render_idealized(kitti_config(), LONG_SCANS)
    long_mission, long_launches, long_res = phase_long_mission(dev, rendered)
    solvers = phase_solvers(long_res.state)
    long_state = long_res.state
    del long_res
    deferred_mission, deferred_launches = phase_deferred(dev, rendered, long_mission)
    del rendered
    # phases 24-29 work in a git-ignored directory of the checkout, removed
    # afterwards; 24-26 run the tools in subprocesses on a thread of their
    # own (the card and the host's cores have room for both): 26 beside
    # phases 13-15, then 24-25 on phase 13's scans beside phases 16-23;
    # 27-29 run after them
    work = tempfile.mkdtemp(prefix="_chip_tools_", dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        beside = concurrent.futures.ThreadPoolExecutor(1)
        tool_26 = beside.submit(phase_sharded_endurance, dev, work)
        physics, physics_scans = phase_physics(dev)
        tools_24_25 = beside.submit(phase_tools_beside, dev, physics_scans, physics, work)
        beside.shutdown(wait=False)
        voxel, voxel_launches, voxel_records = phase_voxel(dev)
        tree, resume = phase_kitti_tree(dev, physics_scans, physics)
        chunks = phase_chunk(dev, slice_records)
        sharded, sharded_records = phase_sharded(dev, voxel, voxel_launches, voxel_records)
        dist_solvers = phase_dist_solvers(dev, long_state, solvers, slice_summary)
        batched = phase_batched(dev, query_world, map_pts, fill)
        nccl = phase_nccl(dev, long_state, sharded_records)
        del long_state
        tool_runs = phase_tools(dev, tool_26, tools_24_25, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del physics_scans
    odom = phase_odometry(dev, slice_scans, map_pts, fill, query_world)
    # the profile runs last: after a torch.profiler window every later
    # launch in the process cost more (phases 13-16 ran 1.1-1.9x slower
    # behind it than without it)
    profile = phase_profile(dev, slice_scans)
    print(f"    all phases in {time.perf_counter() - t_start:.1f} s")

    slice_path = f"kitti_config slice, {slice_summary['scans']} scans (phase 5)"
    mission_path = f"radius mission, {mission['scans']} scans (phase 8)"
    long_path = f"long mission, {long_mission['scans']} scans (phase 9)"
    deferred_path = f"deferred long mission, {deferred_mission['scans']} scans (phase 11)"
    scan, mapq = k1["scan 8192x8192"], k1["map 8192x262144"]
    k4 = k4_times["scan 8192x8192"]
    kernels = [
        {"name": "nn1", "route": "cuda", "source": "icpslam_tpu_torch/csrc/nn1.cu",
         "replaces": "icpslam_tpu/ops/pallas/nn_kernel.py:309",
         "launches": mission_launches["nn1"], "path": mission_path,
         "max_abs_err": k1_err, "ms": scan["ms"], "plain_ms": scan["plain_ms"],
         "bound_ms": scan["bound_ms"], "bound_by": scan["bound_by"], "library_ms": None,
         "bound_all_pairs_ms": scan["bound_all_pairs_ms"], "pairs_share": scan["pairs_share"],
         "launches_scan_target": mission_launches["nn1_scan"],
         "launches_map_target": mission_launches["nn1_map"],
         "map": {**mapq, "fill": fill}},
        {"name": "knn", "route": "cuda", "source": "icpslam_tpu_torch/csrc/knn.cu",
         "replaces": "icpslam_tpu/ops/pallas/nn_kernel.py:450",
         "launches": slice_launches["knn"], "path": slice_path,
         "max_abs_err": k2_err, "library_ms": None, **k2},
        {"name": "radius_moments", "route": "cuda",
         "source": "icpslam_tpu_torch/csrc/radius_moments.cu",
         "replaces": "icpslam_tpu/ops/pallas/radius_stats_kernel.py:69",
         "launches": mission_launches["radius"], "path": mission_path,
         "max_abs_err": k3_err, "library_ms": None, **k3},
        {"name": "nn1_matmul", "route": "cuda", "source": "icpslam_tpu_torch/csrc/nn1_matmul.cu",
         "replaces": "icpslam_tpu/ops/pallas/nn_kernel.py:123",
         "launches": mission_launches["nn1_matmul"],
         "path": "none: no path of slam_step calls it (nor in JAX)",
         "max_abs_err": k4_err, "library_ms": None, **k4,
         "map": k4_times["map 8192x262144"]},
    ]
    physics_path = f"physics mission, {physics['physics']['scans']} scans (phase 13)"
    ins_path = f"INS-deskewed physics mission, {physics['ins']['scans']} scans (phase 14)"
    voxel_path = f"voxel-map slice, {voxel['scans']} scans (phase 16)"
    tree_path = f"KITTI tree through runner.main, {tree['scans']} scans (phase 17)"
    sharded_path = f"sharded-map slice over {SHARDS} shards, {SLICE_SCANS} scans (phase 20)"
    batched_path = f"batched multi-shard step, {batched['pairs']} pairs (phase 22)"
    for entry in kernels:
        key = {"nn1": "nn1", "knn": "knn", "radius_moments": "radius",
               "nn1_matmul": "nn1_matmul"}[entry["name"]]
        entry["long_mission_launches"] = long_launches[key]
        entry["long_mission_path"] = long_path
        entry["deferred_mission_launches"] = deferred_launches[key]
        entry["deferred_mission_path"] = deferred_path
        entry["physics_mission_launches"] = physics["physics_launches"][key]
        entry["physics_mission_path"] = physics_path
        entry["ins_mission_launches"] = physics["ins_launches"][key]
        entry["ins_mission_path"] = ins_path
        entry["voxel_slice_launches"] = voxel_launches[key]
        entry["voxel_slice_path"] = voxel_path
        entry["kitti_tree_launches"] = tree["launches"][key]
        entry["kitti_tree_path"] = tree_path
        entry["sharded_slice_launches"] = sharded[SHARDS]["launches"][key]
        entry["sharded_slice_path"] = sharded_path
        entry["batched_step_launches"] = batched["launches"][key]
        entry["batched_step_path"] = batched_path
        entry["odometry_front_end_launches"] = odom["one_by_one"]["launches"][key]
        entry["odometry_front_end_path"] = (
            f"odometry front end alone, odometry_step one by one, {odom['scans']} scans "
            "(phase 30)")
        for field, launches, path in _tool_launches(tool_runs):
            entry[f"{field}_launches"] = launches.get(key, 0)
            entry[f"{field}_path"] = path
    if args.out:
        with open(args.out, "w") as f:
            json.dump({
                "kernels": kernels,
                "nn1_matmul_vs_nn1_ms": k4_times,
                "sentinel": sentinel, "slice": slice_summary,
                "slice_launches": slice_launches, "mission": mission,
                "mission_launches": mission_launches,
                "long_mission": long_mission, "long_mission_launches": long_launches,
                "solvers": solvers, "deferred_mission": deferred_mission,
                "deferred_mission_launches": deferred_launches, "profile": profile,
                "physics": physics, "voxel": voxel, "voxel_launches": voxel_launches,
                "kitti_tree": tree, "resume": resume, "chunks": chunks,
                "sharded": sharded, "dist_solvers": dist_solvers, "batched": batched,
                "nccl": nccl, "tools": tool_runs, "odometry": odom,
                "device": torch.cuda.get_device_name(0), "card": card,
            }, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def _adopt_orphans() -> None:
    """Make this process the subreaper of its descendants (Linux's
    ``PR_SET_CHILD_SUBREAPER``): an orphan of a process it started becomes
    its child, where ``_stop_children`` finds it."""
    import ctypes

    try:
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    except (AttributeError, OSError):
        pass


def _descendants(root: int) -> dict:
    """``{pid: command line}`` of every live descendant of ``root``, read
    from ``/proc``."""
    import os

    parent = {}
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if fields[0] != "Z":
                parent[int(entry)] = int(fields[1])
    found, todo = {}, [root]
    while todo:
        ppid = todo.pop()
        kids = [pid for pid, pp in parent.items() if pp == ppid]
        for pid in kids:
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    found[pid] = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
            except OSError:
                found[pid] = "?"
        todo += kids
    return found


def _stop_children() -> dict:
    """Stop every process this one started that still runs: close
    multiprocessing's resource tracker as the interpreter would at exit,
    then kill every other descendant and wait for it (and reap any child
    already done). Returns ``{pid: command line}`` of those killed."""
    import gc
    import os
    import signal
    from multiprocessing import resource_tracker

    gc.collect()
    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()
    killed = {}
    while True:
        _reap()
        left = _descendants(os.getpid())
        if not left:
            return killed
        for pid, cmd in left.items():
            if pid not in killed:
                print(f"chip_smoke: stopping process {pid} left running: {cmd}", file=sys.stderr)
                killed[pid] = cmd
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        time.sleep(0.05)


def _reap() -> None:
    """Wait for every child that has ended, without blocking."""
    import os

    while True:
        try:
            if os.waitpid(-1, os.WNOHANG)[0] == 0:
                return
        except ChildProcessError:
            return


def _terminated(signum, frame):
    raise SystemExit(128 + signum)


def _run(argv=None) -> int:
    """``main`` with every process it starts stopped when it ends, also
    when a time limit ends it by SIGTERM."""
    import signal

    _adopt_orphans()
    signal.signal(signal.SIGTERM, _terminated)
    try:
        return main(argv)
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        _stop_children()


if __name__ == "__main__":
    sys.exit(_run())
