"""Speed-of-light accounting for the hot path (port of
``icpslam_tpu/utils/roofline.py``).

Analytic FLOP and bytes-moved models for each pipeline stage at the bench
shapes, the same models and counts as the JAX package's: they bound what
a perfect implementation would move and compute, so ``frac_hbm`` and
``frac_compute`` read as the fraction of the roofline a measured stage
time achieves. ``bound`` keeps the JAX model's label for the unit the
stage is expected to be limited by.

:func:`achieved` divides by the published peaks of one NVIDIA H100 SXM:
67 TFLOP/s in FP32 outside the tensor cores and 3.35 TB/s of HBM3 (the
values ``chip_smoke.py`` uses). The port keeps TF32 off, so every stage,
matrix products included, is held to the FP32 rate.
"""

from __future__ import annotations

import math
from typing import Dict

H100 = dict(
    hbm_gbps=3350.0,
    fp32_tflops=67.0,
)

_F32 = 4  # bytes


def _stage(flops: float, bytes_: float, bound: str, note: str) -> dict:
    return {"flops": flops, "bytes": bytes_, "bound": bound, "note": note}


def nn_pairs_model(n: int, m: int, sweeps: float = 1.0) -> dict:
    """Fused 1-NN: ~11 operations per (query, target) pair (3 sub, 3 mul,
    2 add and the min/argmin select chain). Minimum traffic per sweep:
    both clouds once, each target tile read again per 1,024-query tile."""
    bq = 1024.0
    reread = max(n / bq, 1.0)
    return _stage(
        flops=11.0 * n * m * sweeps,
        bytes_=(n * 3 * _F32 + reread * m * 4 * _F32) * sweeps,
        bound="vpu-issue",
        note=f"{n}x{m} fused VPU 1-NN, {sweeps:.1f} sweeps",
    )


def voxel_filter_model(raw: int) -> dict:
    """Sort-based voxel downsample: one sort of ``raw`` (key, payload)
    records dominates; traffic ~ 2·raw·record·log2(raw)."""
    rec = 16.0
    passes = math.log2(max(raw, 2))
    return _stage(
        flops=raw * passes * 4,  # compare/permute ops, not FMA flops
        bytes_=2.0 * raw * rec * passes,
        bound="sort-latency",
        note=f"packed-key sort of {raw} records (~{passes:.0f} merge passes)",
    )


def covariance_model(n: int, k: int) -> dict:
    """GICP covariances: k-NN over a blocked N×N distance matmul (the JAX
    model's 3 passes) + (k·27·N) moment accumulation + a 3×3
    eigendecomposition per point (~250 flops)."""
    matmul = 2.0 * 3 * n * n * 3
    topk = 2.0 * n * n
    moments = 27.0 * k * n + 250.0 * n
    block = 512.0
    bytes_ = (n / block) * n * 3 * _F32 + n * (3 + 6) * _F32
    return _stage(
        flops=matmul + topk + moments,
        bytes_=bytes_,
        bound="mxu-f32-high",
        note=f"kNN(k={k}) matmul + moments at N={n}",
    )


def icp_model(n: int, m: int, iterations: float, plane: bool,
              per_iter_nn: bool = True) -> dict:
    """GICP GN step: optional per-iteration NN sweep + assembly (~200
    flops/point for the 27-accumulator plane path, ~60 for Kabsch) + one
    6×6 solve (negligible)."""
    assembly = (200.0 if plane else 60.0) * n * iterations
    out = _stage(0.0, 0.0, "vpu-issue", "")
    if per_iter_nn:
        nn = nn_pairs_model(n, m, sweeps=iterations)
        out["flops"] = nn["flops"] + assembly
        out["bytes"] = nn["bytes"] + iterations * n * 15 * _F32
        out["note"] = f"{iterations:.1f} iters x ({nn['note']} + GN assembly)"
    else:
        out["flops"] = assembly
        out["bytes"] = iterations * n * 15 * _F32
        out["note"] = f"{iterations:.1f} fixed-correspondence GN iters at N={n}"
    return out


def scan_to_map_model(n: int, map_fill: int, iterations: float, plane: bool,
                      fixed_corr: bool) -> dict:
    """Refinement = one map-NN query (against the live fill) + the mapping
    ICP + one dedup/insert pass."""
    q = nn_pairs_model(n, max(map_fill, n))
    reg = icp_model(n, n, iterations, plane, per_iter_nn=not fixed_corr)
    insert = _stage(10.0 * n, 2.0 * n * 12 * _F32, "hbm", "append insert")
    return _stage(
        q["flops"] + reg["flops"] + insert["flops"],
        q["bytes"] + reg["bytes"] + insert["bytes"],
        "vpu-issue" if not fixed_corr else "map-query+assembly",
        f"map NN at fill {map_fill} + {reg['note']}",
    )


def achieved(model: dict, ms: float) -> dict:
    """Achieved rates and roofline fractions of a stage measured at ``ms``
    on the card, against the H100's FP32 and HBM3 peaks."""
    s = ms / 1e3
    gflops = model["flops"] / s / 1e9
    gbps = model["bytes"] / s / 1e9
    return {
        "ms": round(ms, 3),
        "gflops": round(gflops, 1),
        "gbps": round(gbps, 2),
        "frac_hbm": round(gbps / H100["hbm_gbps"], 4),
        "frac_compute": round(gflops / (H100["fp32_tflops"] * 1e3), 4),
        "bound": model["bound"],
        "note": model["note"],
    }


def stage_rooflines(
    stage_ms: Dict[str, float],
    raw_points: int,
    n_points: int,
    covariance_knn: int,
    odo_iterations: float,
    map_iterations: float,
    map_fill: int,
    plane: bool = True,
    mapping_fixed_corr: bool = True,
) -> Dict[str, dict]:
    """Roofline report for per-stage timings taken on the card."""
    models = {
        "voxel_filter": voxel_filter_model(raw_points),
        "covariances": covariance_model(n_points, covariance_knn),
        "icp_odometry": icp_model(n_points, n_points, odo_iterations, plane),
        "scan_to_map_refine": scan_to_map_model(
            n_points, map_fill, map_iterations, plane, mapping_fixed_corr
        ),
    }
    return {name: achieved(models[name], ms) for name, ms in stage_ms.items() if name in models}
