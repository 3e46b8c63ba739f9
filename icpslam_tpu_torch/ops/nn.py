"""Exact nearest-neighbour search (port of ``icpslam_tpu/ops/nn.py``).

Each public function dispatches on the device of its tensors:

- a CUDA tensor goes to the hand-written kernel (``csrc/nn1.cu`` for
  :func:`nearest_neighbors`, ``csrc/knn.cu`` for :func:`knn`,
  ``csrc/nn1_matmul.cu`` for :func:`nearest_neighbors_matmul`), or the
  call raises — there is no fallback;
- a CPU tensor goes to the plain PyTorch version beside it
  (:func:`nearest_neighbors_plain`, :func:`knn_plain`,
  :func:`nearest_neighbors_matmul_plain`).

K1 and K2 compute the subtraction-form ``Σ_c (t_c − q_c)²`` in float32
on coordinates centred on the query centroid and order results by (d²,
index), so kernel and plain version agree bit for bit on distances and
exactly on indices, exact ties included (the lowest index wins). K4 is
the matmul form ``|t|² − 2 t·q + |q|²`` of the JAX v1 kernel, which no
path of ``slam_step`` calls.
JAX's TPU tile constraint (``pick_tiles``) has no counterpart: the kernels
take any N and M and mask the ragged edge themselves.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from icpslam_tpu_torch.ops import cuda_build
from icpslam_tpu_torch.utils import profiling

_INF = float("inf")


class NNResult(NamedTuple):
    idx: torch.Tensor    # (N,) int64 index of the nearest target (0 if none)
    dist2: torch.Tensor  # (N,) squared distance (inf where no live target)


def _check(query, target, target_mask, valid_len=None, need_contiguous=False):
    if query.ndim != 2 or query.shape[1] != 3:
        raise ValueError(f"query must be (N, 3), got {tuple(query.shape)}")
    if target.ndim != 2 or target.shape[1] != 3:
        raise ValueError(f"target must be (M, 3), got {tuple(target.shape)}")
    if target_mask.shape != (target.shape[0],) or target_mask.dtype != torch.bool:
        raise ValueError("target_mask must be a (M,) bool tensor")
    if query.dtype != torch.float32 or target.dtype != torch.float32:
        raise TypeError("query and target must be float32")
    devs = {query.device, target.device, target_mask.device}
    if valid_len is not None:
        if valid_len.ndim != 0 or valid_len.dtype != torch.int32:
            raise TypeError("valid_len must be a 0-d int32 tensor")
        devs.add(valid_len.device)
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")
    dev = query.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if need_contiguous and not (
        query.is_contiguous() and target.is_contiguous() and target_mask.is_contiguous()
    ):
        raise ValueError("the CUDA kernels take contiguous tensors only")
    return dev


def _sqdist(e: torch.Tensor) -> torch.Tensor:
    """((e0² + e1²) + e2²) — the kernels' exact evaluation order."""
    return e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1] + e[..., 2] * e[..., 2]


def _block_sqdist(tc: torch.Tensor, qc: torch.Tensor) -> torch.Tensor:
    """(n, m) ``_sqdist`` of every (query, target) pair, one coordinate at a
    time: the same operations in the same order, without the (n, m, 3)
    difference tensor."""
    d = tc[None, :, 0] - qc[:, None, 0]
    d2 = d * d
    d = torch.sub(tc[None, :, 1], qc[:, None, 1], out=d)
    d2 += d * d
    d = torch.sub(tc[None, :, 2], qc[:, None, 2], out=d)
    d2 += d * d
    return d2


def _row_block(m: int) -> int:
    return max(1, (1 << 24) // max(m, 1))


# ---------------------------------------------------------------------------
# K1: 1-NN
# ---------------------------------------------------------------------------


def nearest_neighbors(
    query: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    valid_len: Optional[torch.Tensor] = None,
    prune_beyond: Optional[float] = None,
) -> NNResult:
    """Exact 1-NN of each query among the masked targets; an exact tie
    goes to the lowest index, and no live target gives index 0, d² = inf.

    ``valid_len``: 0-d int32 tensor, the live-prefix length of a
    fixed-capacity target buffer (targets past it must be masked too); it
    stays on the device and the kernel reads it there. ``prune_beyond``
    is the JAX contract's don't-care radius; both versions ignore it and
    are exact everywhere, which the contract allows (the kernel's tile
    skip is exact without it).
    """
    del prune_beyond
    dev = _check(query, target, target_mask, valid_len)
    if dev.type == "cuda":
        return nn1_cuda(query, target, target_mask, valid_len)
    return nearest_neighbors_plain(query, target, target_mask, valid_len)


def nearest_neighbors_plain(query, target, target_mask, valid_len=None) -> NNResult:
    """The plain PyTorch version of K1 (blocked, materialises d²)."""
    _check(query, target, target_mask, valid_len)
    if valid_len is not None:
        live_len = min(max(int(valid_len), 0), target.shape[0])
        target, target_mask = target[:live_len], target_mask[:live_len]
    n, m = query.shape[0], target.shape[0]
    center = query.mean(0)
    qc = query - center
    tc = target - center
    if m == 0:
        return NNResult(
            idx=torch.zeros(n, dtype=torch.int64, device=query.device),
            dist2=torch.full((n,), _INF, device=query.device),
        )
    parts = []
    step = _row_block(m)
    for s in range(0, n, step):
        d2 = _block_sqdist(tc, qc[s : s + step]).masked_fill_(~target_mask[None, :], _INF)
        parts.append(d2.argmin(1))
    idx = torch.cat(parts)
    d2 = _sqdist(tc[idx] - qc)
    found = target_mask[idx]
    return NNResult(
        idx=torch.where(found, idx, torch.zeros_like(idx)),
        dist2=torch.where(found, d2, _INF),
    )


def _scratch(lib, m: int, dev) -> torch.Tensor:
    """The staged target tiles and their AABBs, written by the kernels'
    prologue (``csrc/nn_tiles.cuh``)."""
    return torch.empty(int(lib.icpslam_nn_scratch_floats(m)), dtype=torch.float32, device=dev)


def _pairs_ptr(pairs: Optional[torch.Tensor], dev):
    if pairs is None:
        return None
    if pairs.device != dev or pairs.dtype != torch.int64 or pairs.numel() != 1:
        raise ValueError("pairs must be a one-element int64 tensor on the queries' device")
    return pairs.data_ptr()


def nn1_cuda(query, target, target_mask, valid_len=None, pairs=None) -> NNResult:
    """Launch K1 (``csrc/nn1.cu``) on the current stream.

    Replaces ``icpslam_tpu/ops/pallas/nn_kernel.py::nearest_neighbors_pallas3``.
    Bound on the H100 by the FP32 instruction rate. One call launches a
    prologue that stages the targets in tiles with their AABBs and the
    search kernel: 8 lanes per query, tiles swept only where some query's
    AABB distance does not exceed its best, results as (d², index) keys
    (see the sources). ``valid_len`` is read from device memory.
    ``nn1_cuda.launches`` counts calls. ``pairs`` (a one-element int64
    CUDA tensor, or None) is incremented by the (query, live target)
    pairs the search evaluated.
    """
    dev = _check(query, target, target_mask, valid_len, need_contiguous=True)
    if dev.type != "cuda":
        raise ValueError("nn1_cuda takes CUDA tensors")
    pairs_ptr = _pairs_ptr(pairs, dev)
    lib = cuda_build.load()
    n, m = query.shape[0], target.shape[0]
    center = query.mean(0).contiguous()
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    d2 = torch.empty(n, dtype=torch.float32, device=dev)
    if n:
        scratch = _scratch(lib, m, dev)
        code = lib.icpslam_nn1(
            query.data_ptr(), target.data_ptr(), target_mask.data_ptr(),
            None if valid_len is None else valid_len.data_ptr(),
            center.data_ptr(), n, m, scratch.data_ptr(), scratch.numel(), pairs_ptr,
            idx.data_ptr(), d2.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
        cuda_build.check(code, "icpslam_nn1")
        nn1_cuda.launches += 1
        by_m = nn1_cuda.launches_by_capacity
        by_m[m] = by_m.get(m, 0) + 1
    return NNResult(idx=idx.long(), dist2=d2)


nn1_cuda.launches = 0
profiling.register_attribute("nn1.launches", nn1_cuda, "launches")
# the same calls by target capacity (a scan's max_points, the map's max_map_points)
nn1_cuda.launches_by_capacity = {}


# ---------------------------------------------------------------------------
# K2: k-NN
# ---------------------------------------------------------------------------

KNN_MAX_K = 16


def knn(
    query: torch.Tensor, target: torch.Tensor, target_mask: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN: ``(idx (N, k) int64, dist2 (N, k))``, ascending.

    Where fewer than k live targets exist the trailing entries have
    ``dist2 = inf`` and index 0 (``knn_pallas``'s contract). Exact ties
    keep ascending index order. JAX takes this through an XLA
    (approximate on TPU) top-k; the port is exact.
    """
    if not 1 <= k <= KNN_MAX_K:
        raise ValueError(f"k must be in [1, {KNN_MAX_K}], got {k}")
    dev = _check(query, target, target_mask)
    if dev.type == "cuda":
        return knn_cuda(query, target, target_mask, k)
    return knn_plain(query, target, target_mask, k)


def _smallest_k(d2: torch.Tensor, k: int):
    """The k smallest entries of each row in (d², index) order. d² ≥ 0, so
    its float32 bits order as integers do, and ``bits << 32 | index`` is a
    unique key: ``topk`` over the keys has no ties to order arbitrarily."""
    col = torch.arange(d2.shape[1], device=d2.device)
    key = (d2.view(torch.int32).to(torch.int64) << 32) | col
    vals = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    return (vals >> 32).to(torch.int32).view(torch.float32), vals & 0xFFFFFFFF


def knn_plain(query, target, target_mask, k: int):
    """The plain PyTorch version of K2 (blocked d² + ``topk`` of (d², index) keys)."""
    _check(query, target, target_mask)
    n, m = query.shape[0], target.shape[0]
    center = query.mean(0)
    qc = query - center
    tc = target - center
    idx_parts, d2_parts = [], []
    step = _row_block(m)
    for s in range(0, n, step):
        d2 = _block_sqdist(tc, qc[s : s + step]).masked_fill_(~target_mask[None, :], _INF)
        if m < k:
            d2 = torch.cat([d2, d2.new_full((d2.shape[0], k - m), _INF)], 1)
        vals, idx = _smallest_k(d2, k)
        idx_parts.append(idx)
        d2_parts.append(vals)
    idx = torch.cat(idx_parts) if idx_parts else torch.zeros((0, k), dtype=torch.int64)
    d2 = torch.cat(d2_parts) if d2_parts else torch.zeros((0, k))
    found = torch.isfinite(d2)
    return torch.where(found, idx, torch.zeros_like(idx)), d2


def knn_cuda(query, target, target_mask, k: int, pairs=None):
    """Launch K2 (``csrc/knn.cu``) on the current stream.

    Replaces ``icpslam_tpu/ops/pallas/nn_kernel.py::knn_pallas``: one
    sweep with per-lane k-lists of (d², index) keys in registers instead
    of k exclusion passes, on K1's tiles and AABB skip (against each
    query's k-th best), the lanes' lists merged at the end. Bound by the
    FP32 instruction rate like K1. ``knn_cuda.launches`` counts calls
    (prologue and search); ``pairs`` as in :func:`nn1_cuda`.
    """
    dev = _check(query, target, target_mask, need_contiguous=True)
    if dev.type != "cuda":
        raise ValueError("knn_cuda takes CUDA tensors")
    if not 1 <= k <= KNN_MAX_K:
        raise ValueError(f"k must be in [1, {KNN_MAX_K}], got {k}")
    pairs_ptr = _pairs_ptr(pairs, dev)
    lib = cuda_build.load()
    n, m = query.shape[0], target.shape[0]
    center = query.mean(0).contiguous()
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    d2 = torch.empty((n, k), dtype=torch.float32, device=dev)
    if n:
        scratch = _scratch(lib, m, dev)
        code = lib.icpslam_knn(
            query.data_ptr(), target.data_ptr(), target_mask.data_ptr(),
            center.data_ptr(), n, m, k, scratch.data_ptr(), scratch.numel(), pairs_ptr,
            idx.data_ptr(), d2.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
        cuda_build.check(code, "icpslam_knn")
        knn_cuda.launches += 1
    return idx.long(), d2


knn_cuda.launches = 0
profiling.register_attribute("knn.launches", knn_cuda, "launches")


# ---------------------------------------------------------------------------
# K4: 1-NN in matmul form
# ---------------------------------------------------------------------------


def nearest_neighbors_matmul(
    query: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    valid_len: Optional[torch.Tensor] = None,
) -> NNResult:
    """1-NN by ``d² = |t|² − 2 t·q + |q|²`` on query-centred coordinates,
    in float32 (JAX ``nearest_neighbors_pallas``, v1). Its rounding error
    scales with ``|q|² + |t|²``, not with d²; ``nearest_neighbors`` is the
    exact search the pipeline uses. d² is clamped at 0; no live target
    gives index 0 and d² = inf."""
    dev = _check(query, target, target_mask, valid_len)
    if dev.type == "cuda":
        return nn1_matmul_cuda(query, target, target_mask, valid_len)
    return nearest_neighbors_matmul_plain(query, target, target_mask, valid_len)


def nearest_neighbors_matmul_plain(query, target, target_mask, valid_len=None) -> NNResult:
    """The plain PyTorch version of K4 (blocked ``matmul`` cross term)."""
    _check(query, target, target_mask, valid_len)
    if valid_len is not None:
        live_len = min(max(int(valid_len), 0), target.shape[0])
        target, target_mask = target[:live_len], target_mask[:live_len]
    n, m = query.shape[0], target.shape[0]
    center = query.mean(0)
    qc = query - center
    tc = target - center
    if m == 0:
        return NNResult(
            idx=torch.zeros(n, dtype=torch.int64, device=query.device),
            dist2=torch.full((n,), _INF, device=query.device),
        )
    tn2 = torch.where(target_mask, _sqdist(tc), _INF)
    qn2 = _sqdist(qc)
    idx_parts, d2_parts = [], []
    step = _row_block(m)
    for s in range(0, n, step):
        d2 = tn2[None, :] - 2.0 * (qc[s : s + step] @ tc.T) + qn2[s : s + step, None]
        best, idx = d2.min(1)
        idx_parts.append(idx)
        d2_parts.append(best)
    idx, d2 = torch.cat(idx_parts), torch.cat(d2_parts)
    found = torch.isfinite(d2)
    return NNResult(
        idx=torch.where(found, idx, torch.zeros_like(idx)),
        dist2=torch.where(found, torch.clamp(d2, min=0.0), d2),
    )


def nn1_matmul_cuda(query, target, target_mask, valid_len=None) -> NNResult:
    """Launch K4 (``csrc/nn1_matmul.cu``) on the current stream.

    Replaces ``icpslam_tpu/ops/pallas/nn_kernel.py::nearest_neighbors_pallas``.
    One call launches a prologue that writes each target once as centred
    (t, |t|²) and the sweep: 4 queries per warp held by all 32 lanes,
    each block's tiles staged once in shared memory, the per-pair
    expression pinned to three FMAs, the lanes' bests merged as (value,
    index) keys. FP32 on the CUDA cores, no tensor cores; bound by FP32
    instruction issue. ``nn1_matmul_cuda.launches`` counts calls.
    """
    dev = _check(query, target, target_mask, valid_len, need_contiguous=True)
    if dev.type != "cuda":
        raise ValueError("nn1_matmul_cuda takes CUDA tensors")
    lib = cuda_build.load()
    n, m = query.shape[0], target.shape[0]
    center = query.mean(0).contiguous()
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    d2 = torch.empty(n, dtype=torch.float32, device=dev)
    if n:
        scratch = torch.empty(int(lib.icpslam_nn1_matmul_scratch_floats(m)),
                              dtype=torch.float32, device=dev)
        code = lib.icpslam_nn1_matmul(
            query.data_ptr(), target.data_ptr(), target_mask.data_ptr(),
            None if valid_len is None else valid_len.data_ptr(),
            center.data_ptr(), n, m, scratch.data_ptr(), scratch.numel(),
            idx.data_ptr(), d2.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
        cuda_build.check(code, "icpslam_nn1_matmul")
        nn1_matmul_cuda.launches += 1
    return NNResult(idx=idx.long(), dist2=d2)


nn1_matmul_cuda.launches = 0
profiling.register_attribute("nn1_matmul.launches", nn1_matmul_cuda, "launches")
