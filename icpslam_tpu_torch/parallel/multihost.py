"""Multi-process initialization and process-level utilities (port of
``icpslam_tpu/parallel/multihost.py``).

JAX connects its host processes with ``jax.distributed.initialize``; the
port connects its ranks with ``torch.distributed.init_process_group``:
NCCL when the ranks hold CUDA cards, gloo on the CPU. After it,
:func:`global_mesh` spans every rank, and the shard bodies of
``parallel/`` reduce across the group. The streaming loop's scans are
replicated (every rank steps the same scan); the map's shards and the
graph's edge shards live on their ranks.

Nothing tells a program of a cluster: the address, world size and rank
come from the caller or from torchrun's environment (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``). Every initialization takes a
timeout, so a dead peer fails the run instead of hanging it.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from icpslam_tpu_torch.parallel.mesh import Mesh, make_mesh
from icpslam_tpu_torch.utils.device import resolve as resolve_device

_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    timeout_s: float = 300.0,
) -> None:
    """Connect this process to the process group.

    ``coordinator_address`` (``host:port`` or an ``init_method`` URL such
    as ``file://...``) with ``num_processes`` and ``process_id`` is an
    explicit cluster: a failure to rendezvous raises, since a process
    left single would shard wrong. Without it the torchrun environment is
    read; where it is absent the process runs single, and says so in the
    log. No-op when a group is already initialized. ``device`` picks the
    backend: NCCL for the CUDA card (the default), gloo for ``"cpu"``.
    """
    if dist.is_initialized():
        return
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is not None:
        url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=url, world_size=num_processes,
                                rank=process_id, timeout=timeout)
        return
    missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
    if missing:
        logging.getLogger(__name__).info(
            "torch.distributed: no torchrun environment (%s unset); running single-process",
            ", ".join(missing))
        return
    dist.init_process_group(backend, init_method="env://", timeout=timeout)


def global_mesh(axis: str = "dp", device=None) -> Mesh:
    """A 1-D mesh of one shard per rank over the whole group (one shard
    without a group)."""
    return make_mesh(None, axis=axis, device=device)


def replicate_to_global(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` on the mesh's device, equal on every rank: rank 0's copy is
    broadcast over the group."""
    if mesh.world == 1:
        return x.to(mesh.device)
    x = x.to(mesh.device).clone()
    dist.broadcast(x, src=0, group=mesh.group)
    return x


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0
