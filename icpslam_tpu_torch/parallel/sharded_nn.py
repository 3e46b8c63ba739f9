"""Query-sharded exact nearest-neighbour search (port of
``icpslam_tpu/parallel/sharded_nn.py``).

The query cloud is cut into D blocks, one per shard, and the target is
replicated; each shard's block goes through ``ops/nn.nearest_neighbors``
(kernel K1 on the card), one launch per local shard, and the ranks'
blocks are gathered. K1 treats every query on its own, so the result
equals one call on all the queries, index and d² bits alike.
"""

from __future__ import annotations

import torch

from icpslam_tpu_torch.ops import nn as nn_ops
from icpslam_tpu_torch.parallel.mesh import Mesh


def nearest_neighbors(
    query: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    mesh: Mesh,
) -> nn_ops.NNResult:
    """Exact 1-NN with the queries sharded over the mesh. The query count
    must be divisible by the shard count (pad upstream with masked points)."""
    n = mesh.size
    Q = query.shape[0]
    if Q % n != 0:
        raise ValueError(f"query count {Q} not divisible by mesh size {n}")
    per = Q // n
    idx, d2 = [], []
    for s in range(mesh.first, mesh.first + mesh.local):
        res = nn_ops.nearest_neighbors(query[s * per:(s + 1) * per], target, target_mask)
        idx.append(res.idx)
        d2.append(res.dist2)
    return nn_ops.NNResult(idx=mesh.all_gather_tiled(torch.cat(idx)),
                           dist2=mesh.all_gather_tiled(torch.cat(d2)))
