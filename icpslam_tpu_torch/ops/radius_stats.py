"""Fixed-radius neighbourhood moments (port of
``icpslam_tpu/ops/pallas/radius_stats_kernel.py``).

For each query, over the live targets within ``radius``: the weight sum
(the neighbour count for the hard cutoff, ``Σ exp(−d²/2σ²)`` with a
taper), the mean and the centred (population) covariance. :func:`radius_moments`
dispatches on the device like ``ops/nn.py``: a CUDA tensor goes to kernel
K3 (``csrc/radius_moments.cu``) or the call raises; a CPU tensor goes to
:func:`radius_moments_plain`. K3 sweeps only the target tiles whose
bounding box lies within the radius of some query of a warp;
:func:`swept_pairs_plain` computes that rule on any device, for the tests
and ``chip_smoke.py`` (the main path never calls it).

Both versions accumulate per query, on ``e = t − q``, and decide
membership on the subtraction-form ``d² = ((e_x² + e_y²) + e_z²) < r²``
in float32, bit for bit alike. The JAX function decides it in matmul
form on centroid-centred coordinates, so a pair within ~1e-5·r² of the
boundary can count in one and not in the other.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from icpslam_tpu_torch.ops import cuda_build
from icpslam_tpu_torch.ops.nn import _check, _pairs_ptr, _scratch, _sqdist
from icpslam_tpu_torch.utils import profiling

Moments = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# K3's targets per tile (csrc/nn_tiles.cuh kTile)
RADIUS_TILE = 256
# queries per warp of the tiled search (csrc/nn_tiles.cuh kQ)
QUERIES_PER_WARP = 4


def _params(radius: float, sigma: float) -> Tuple[float, float]:
    """(r², 1/2σ²) as float32 values (1/2σ² = 0 for the hard cutoff)."""
    r2 = float(np.float32(float(radius) * float(radius)))
    inv2s2 = 0.0 if sigma <= 0 else float(np.float32(1.0 / (2.0 * float(sigma) ** 2)))
    return r2, inv2s2


def radius_moments(
    query: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    radius: float,
    sigma: float = 0.0,
) -> Moments:
    """``(count (N,), mean (N, 3), cov (N, 3, 3))`` of the masked targets
    with ``d² < radius²`` around each query; ``sigma > 0`` weights them by
    ``exp(−d²/2σ²)`` and ``count`` is then ``Σw``. All zero where count is 0."""
    dev = _check(query, target, target_mask)
    if dev.type == "cuda":
        return radius_moments_cuda(query, target, target_mask, radius, sigma)
    return radius_moments_plain(query, target, target_mask, radius, sigma)


def _finish(q, sw, s1, s2) -> Moments:
    """count, mean and covariance from the per-query sums (the kernel's
    epilogue: ``m = s/Σw``, ``mean = q + m``, ``cov = S/Σw − m mᵀ``)."""
    has = sw > 0
    safe = torch.where(has, sw, torch.ones_like(sw))
    m = s1 / safe[:, None]
    cov = s2 / safe[:, None, None] - m[:, :, None] * m[:, None, :]
    return (
        sw,
        torch.where(has[:, None], q + m, 0.0),
        torch.where(has[:, None, None], cov, 0.0),
    )


def radius_moments_plain(query, target, target_mask, radius: float, sigma: float = 0.0) -> Moments:
    """The plain PyTorch version of K3: blocked over queries, the same
    per-query sums as the kernel (reduced in another order)."""
    _check(query, target, target_mask)
    r2, inv2s2 = _params(radius, sigma)
    n, m = query.shape[0], target.shape[0]
    sw_parts, s1_parts, s2_parts = [], [], []
    step = max(1, (1 << 22) // max(m, 1))
    for s in range(0, n, step):
        e = target[None, :, :] - query[s : s + step, None, :]     # (B, M, 3)
        d2 = _sqdist(e)
        inside = target_mask[None, :] & (d2 < r2)
        if inv2s2 > 0:
            w = torch.where(inside, torch.exp(-d2 * inv2s2), 0.0)
        else:
            w = inside.to(e.dtype)
        we = w[..., None] * e
        sw_parts.append(w.sum(1))
        s1_parts.append(we.sum(1))
        s2_parts.append(we.mT @ e)                                 # (B, 3, 3)
    if not sw_parts:
        z = query.new_zeros((0,))
        return z, query.new_zeros((0, 3)), query.new_zeros((0, 3, 3))
    return _finish(query, torch.cat(sw_parts), torch.cat(s1_parts), torch.cat(s2_parts))


def swept_tiles(query, target, target_mask, radius: float, tile: int = RADIUS_TILE):
    """K3's skip rule: ``(swept (W, T) bool, live (T,) int64)`` for the W
    warps of ``QUERIES_PER_WARP`` consecutive queries and the T tiles of
    ``tile`` consecutive targets. A warp sweeps a tile iff some of its
    queries has the squared distance to the box of the tile's live targets,
    rounded as the kernel rounds it (``nn_tiles.cuh::aabb_lb2``), finite
    and ``<= r²``; ``live`` counts each tile's live targets."""
    _check(query, target, target_mask)
    r2, _ = _params(radius, 0.0)
    n, m = query.shape[0], target.shape[0]
    nt = -(-m // tile)
    inf = float("inf")
    pad = nt * tile - m
    t = torch.cat([target, target.new_zeros((pad, 3))]).view(nt, tile, 3)
    live = torch.cat([target_mask, target_mask.new_zeros(pad)]).view(nt, tile)
    lo = torch.where(live[..., None], t, inf).amin(1)
    hi = torch.where(live[..., None], t, -inf).amax(1)
    q = query[:, None, :]
    gap = torch.clamp(torch.maximum(lo[None] - q, q - hi[None]), min=0.0)
    lb2 = _sqdist(gap)                                              # (N, T)
    need = (lb2 <= r2) & torch.isfinite(lb2)
    w = -(-n // QUERIES_PER_WARP)
    need = torch.cat([need, need.new_zeros((w * QUERIES_PER_WARP - n, nt))])
    return need.view(w, QUERIES_PER_WARP, nt).any(1), live.sum(1)


def swept_pairs_plain(query, target, target_mask, radius: float, tile: int = RADIUS_TILE) -> int:
    """The (query, live target) pairs K3 sweeps under :func:`swept_tiles`,
    each swept tile counted for every query of the warp: what its
    ``pairs`` counter reports."""
    swept, live = swept_tiles(query, target, target_mask, radius, tile)
    n = query.shape[0]
    per_warp = torch.clamp(n - QUERIES_PER_WARP * torch.arange(swept.shape[0], device=query.device),
                           max=QUERIES_PER_WARP)
    return int((per_warp * (swept * live[None]).sum(1)).sum())


def radius_moments_cuda(query, target, target_mask, radius: float, sigma: float = 0.0,
                        pairs=None) -> Moments:
    """Launch K3 (``csrc/radius_moments.cu``) on the current stream.

    Replaces ``icpslam_tpu/ops/pallas/radius_stats_kernel.py::radius_moments``.
    One call launches a prologue that stages the targets in tiles with
    their bounding boxes and the tiled search of K1 against the fixed bound
    r²: 8 lanes per query, a tile swept only where some query of the warp
    lies within r of its box, the lanes' 10 sums merged by shuffles. Bound
    on the H100 by FP32 instruction issue. ``radius_moments_cuda.launches``
    counts calls. ``pairs`` (a one-element int64 CUDA tensor, or None) is
    incremented by the (query, live target) pairs swept.
    """
    dev = _check(query, target, target_mask, need_contiguous=True)
    if dev.type != "cuda":
        raise ValueError("radius_moments_cuda takes CUDA tensors")
    pairs_ptr = _pairs_ptr(pairs, dev)
    lib = cuda_build.load()
    r2, inv2s2 = _params(radius, sigma)
    n, m = query.shape[0], target.shape[0]
    count = torch.empty(n, dtype=torch.float32, device=dev)
    mean = torch.empty((n, 3), dtype=torch.float32, device=dev)
    cov = torch.empty((n, 3, 3), dtype=torch.float32, device=dev)
    if n:
        zero = torch.zeros(3, dtype=torch.float32, device=dev)
        scratch = _scratch(lib, m, dev)
        code = lib.icpslam_radius_moments(
            query.data_ptr(), target.data_ptr(), target_mask.data_ptr(), zero.data_ptr(),
            n, m, r2, inv2s2, scratch.data_ptr(), scratch.numel(), pairs_ptr,
            count.data_ptr(), mean.data_ptr(), cov.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        cuda_build.check(code, "icpslam_radius_moments")
        radius_moments_cuda.launches += 1
    return count, mean, cov


radius_moments_cuda.launches = 0
profiling.register_attribute("radius.launches", radius_moments_cuda, "launches")
