"""A mesh of shards over ranks (port of ``icpslam_tpu/parallel/mesh.py``).

In JAX a ``Mesh`` is a list of devices: the sharded state carries a
leading device axis ``(D, ...)`` and ``shard_map`` runs the per-device
body, reducing across devices with ``psum``, ``pmin`` and ``all_gather``.
The JAX tests get D = 8 from one process with 8 virtual CPU devices.

A machine with one H100 cannot run two NCCL ranks on its card, so a
literal one-rank-per-device port could only ever run D = 1 there, where
every collective is trivial. The port therefore separates **shards** from
**ranks**: a :class:`Mesh` holds ``size`` = D shards over ``world`` = W
ranks of a ``torch.distributed`` process group (or of no group: W = 1),
``local`` = D / W of them on each rank. The per-shard bodies run over the
rank's local shard axis, and each collective reduces or concatenates over
that axis first, then, on a mesh with a group (even of one rank), across
it with ``dist.all_reduce`` or ``dist.all_gather_into_tensor``. This is what
``shard_map`` over an 8-device mesh computes, laid out for a machine
with one card: at W = 1 the sharded state has JAX's global layout
exactly, ``(D, ...)`` leaves, so checkpoints cross between the packages.

JAX's ``shard_leading`` becomes a layout helper here (the rank's slab of
a global tensor's leading axis); JAX's ``replicated`` has no counterpart:
a replicated tensor is the same plain tensor on every rank.

Axis conventions used across ``parallel/``: ``"dp"``, data parallel over
independent work items (scan pairs, graph-edge shards, NN query blocks).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from icpslam_tpu_torch.utils.device import resolve as resolve_device


def _ablated() -> bool:
    # local import: dist_graph imports this module; the knob lives there,
    # under JAX's name (dist_graph.ABLATE_COLLECTIVES)
    from icpslam_tpu_torch.parallel import dist_graph

    return dist_graph.ABLATE_COLLECTIVES


@dataclasses.dataclass(frozen=True)
class Mesh:
    """D = ``size`` shards, ``local`` of them on each of ``world`` ranks."""

    size: int
    group: Optional[object]  # a torch.distributed ProcessGroup, or None
    world: int
    rank: int
    device: torch.device
    axis: str = "dp"

    def __post_init__(self):
        if self.size < 1 or self.world < 1 or self.size % self.world:
            raise ValueError(f"mesh of {self.size} shards over {self.world} ranks: the shard "
                             "count must be a positive multiple of the world size")

    @property
    def local(self) -> int:
        """The shards this rank holds."""
        return self.size // self.world

    @property
    def first(self) -> int:
        """The global index of this rank's first shard."""
        return self.rank * self.local

    def shard_ids(self) -> torch.Tensor:
        """(local,) int32 global indices of this rank's shards."""
        return torch.arange(self.first, self.first + self.local, dtype=torch.int32,
                            device=self.device)

    def _cross(self) -> bool:
        return self.group is not None and not _ablated()

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the leading (local shard) axis, then over the ranks; the
        dtype is kept. One local shard is taken as it is, as JAX's psum over
        one device does (a reduction would turn -0.0 into +0.0)."""
        y = x[0].clone() if x.shape[0] == 1 else x.sum(0, dtype=x.dtype)
        if self._cross():
            y = y.contiguous()
            dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.group)
        return y

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        """Minimum over the leading (local shard) axis, then over the ranks."""
        y = x.amin(0)
        if self._cross():
            y = y.contiguous()
            dist.all_reduce(y, op=dist.ReduceOp.MIN, group=self.group)
        return y

    def all_gather_tiled(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (equal shapes) concatenated along axis 0 in
        rank order: (local, ...) shard slabs become (D, ...). With the
        collectives ablated each rank repeats its own slab."""
        if self.group is None:
            return x
        if _ablated():
            return torch.cat([x] * self.world, 0)
        out = x.new_empty((self.world * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=self.group)
        return out


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp", device=None) -> Mesh:
    """A 1-D mesh of ``n_devices`` shards (JAX's name for D).

    Without an initialized process group one process holds all D shards on
    ``device`` (default 1 shard). With one, D = ``n_devices`` (default:
    the world size) must divide by the world size W, and each rank holds
    D / W. ``device`` is the CUDA card by default and raises without one;
    the CPU runs only when named.
    """
    device = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        world, rank, group = dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    else:
        world, rank, group = 1, 0, None
    size = world if n_devices is None else int(n_devices)
    return Mesh(size=size, group=group, world=world, rank=rank, device=device, axis=axis)


def shard_leading(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous slab of ``x``'s leading axis (JAX's
    ``P(axis)`` placement); the axis must divide by the world size."""
    n = x.shape[0]
    if n % mesh.world:
        raise ValueError(f"leading axis {n} does not divide over {mesh.world} ranks")
    per = n // mesh.world
    return x[mesh.rank * per:(mesh.rank + 1) * per]


def pad_to_multiple(n: int, k: int) -> int:
    return (n + k - 1) // k * k
