"""The pose-graph solves captured as CUDA graphs (the port's counterpart of
the ``jax.jit`` cache that compiles the JAX package's solves once per
shape).

A solve dispatched op by op costs the host a few thousand kernel launches
(PCG on 512 nodes: 3 LM steps of 50 CG steps). :class:`CapturedSolves`
keeps one ``torch.cuda.CUDAGraph`` per solve shape — the full solve of one
bucket with one linear solver (``pose_graph.solve_bucket``) or the window
solve (``pose_graph.optimize_window``), per iteration count, mode and
option — captured at its first use by ``utils/cuda_graphs.capture``. Each
graph owns static input buffers (the node poses, the node mask, every
field of the edge store and the keyframe count, from which the window's
``start`` is computed on the device) and the static outputs it wrote
during capture (poses and solve stats). A replay copies the inputs in and
launches the whole graph with one call, on the current stream.

Schur is not captured: its ``ok`` is read on the host at every LM step
(``pose_graph._schur_step``), a device-to-host copy that a capture does
not allow, so it stays eager and :meth:`CapturedSolves.full` refuses it.
The edge-sharded solves of ``parallel/dist_graph.py`` on a mesh without a
process group reduce over the local shard axis only, so they are
captured per bucket like the replicated ones; on a mesh with a group
their collectives are not captured (gloo cannot be, and NCCL capture is
not proven here), so they run eager and :meth:`CapturedSolves.full`
refuses them. A capture or replay that fails raises; nothing falls back
to the eager solve.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.graph import pose_graph as pg
from icpslam_tpu_torch.parallel import dist_graph
from icpslam_tpu_torch.utils import cuda_graphs

_EDGE_FIELDS = pg.EdgeSet._fields


def _inputs(nodes: Pose, edges: pg.EdgeSet, node_mask: torch.Tensor,
            count: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    out = {"t": nodes.t, "q": nodes.q, "mask": node_mask}
    out.update({"e_" + f: getattr(edges, f) for f in _EDGE_FIELDS})
    if count is not None:
        out["count"] = count
    return out


def _unpack(x: Dict[str, torch.Tensor]):
    edges = pg.EdgeSet(**{f: x["e_" + f] for f in _EDGE_FIELDS})
    return Pose(t=x["t"], q=x["q"]), edges, x["mask"], x.get("count")


class CapturedSolve:
    """One captured solve: its graph, static inputs and static outputs."""

    def __init__(self, graph: torch.cuda.CUDAGraph, inputs: Dict[str, torch.Tensor],
                 outputs: Tuple[Pose, pg.SolveStats], counter: Optional[Tuple[object, str]]):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.counter = counter  # (owner, attribute) of the solve's call counter
        self.replays = 0

    def load(self, inputs: Dict[str, torch.Tensor]) -> None:
        """Copy ``inputs`` into the static input buffers (on the current
        stream)."""
        for name, buf in self.inputs.items():
            src = inputs[name]
            if src.device != buf.device:
                raise ValueError(f"captured solve: input {name!r} is on {src.device}, "
                                 f"not {buf.device}")
            if src.shape != buf.shape or src.dtype != buf.dtype:
                raise ValueError(f"captured solve: input {name!r} is {tuple(src.shape)} "
                                 f"{src.dtype}, the graph was captured for "
                                 f"{tuple(buf.shape)} {buf.dtype}")
            buf.copy_(src)

    def run(self) -> Tuple[Pose, pg.SolveStats]:
        """Replay on the current stream; returns copies of the outputs, so a
        later replay leaves them as they are."""
        self.graph.replay()
        self.replays += 1
        if self.counter is not None:
            owner, attr = self.counter
            setattr(owner, attr, getattr(owner, attr) + 1)
        nodes, stats = self.outputs
        return (Pose(t=nodes.t.clone(), q=nodes.q.clone()),
                pg.SolveStats(*(x.clone() for x in stats)))


class CapturedSolves:
    """The captured solves of one CUDA device, keyed by shape and options."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"CapturedSolves needs a CUDA device, got {self.device}")
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.graphs: Dict[tuple, CapturedSolve] = {}

    def _get(self, key: tuple, inputs: Dict[str, torch.Tensor],
             solve: Callable[[Dict[str, torch.Tensor]], Tuple[Pose, pg.SolveStats]],
             counter: Optional[Tuple[object, str]]) -> CapturedSolve:
        shapes = tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(inputs.items()))
        key = key + shapes
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(inputs, solve, counter)
        return g

    def _capture(self, inputs, solve, counter) -> CapturedSolve:
        for name, x in inputs.items():
            if x.device != self.device:
                raise ValueError(f"captured solve: input {name!r} is on {x.device}, "
                                 f"not {self.device}")
        static = {k: v.clone() for k, v in inputs.items()}
        graph, outputs = cuda_graphs.capture(lambda: solve(static), self.device)
        return CapturedSolve(graph, static, outputs, counter)

    def prepare_full(self, nodes: Pose, edges: pg.EdgeSet, node_mask: torch.Tensor,
                     bucket: int, linear_solver: str, mesh=None, **kw) -> CapturedSolve:
        """The captured ``solve_bucket`` of this bucket and solver with its
        inputs loaded; ``.run()`` replays it. With ``mesh`` the bucket is
        solved by ``dist_graph.optimize`` on it (a mesh without a process
        group)."""
        if linear_solver not in ("direct", "pcg"):
            raise ValueError(f"linear_solver={linear_solver!r} is not captured "
                             "(Schur reads its ok flag on the host; 'auto' is resolved "
                             "by the caller)")
        if mesh is not None and mesh.group is not None:
            raise ValueError("a dist-* solve on a mesh with a process group is not captured "
                             "(its collectives run eager)")
        optimize_fn = None if mesh is None else functools.partial(dist_graph.optimize, mesh=mesh)

        def solve(x):
            nds, es, mask, _ = _unpack(x)
            return pg.solve_bucket(nds, es, mask, bucket, linear_solver,
                                   optimize_fn=optimize_fn, **kw)

        inputs = _inputs(nodes, edges, node_mask)
        if mesh is not None:
            counter = (dist_graph.optimize, "replays")
        else:
            counter = (pg.optimize, "pcg_solves") if linear_solver == "pcg" else None
        key = ("full", linear_solver, bucket, tuple(sorted(kw.items())),
               None if mesh is None else mesh.size)
        g = self._get(key, inputs, solve, counter)
        g.load(inputs)
        return g

    def prepare_window(self, nodes: Pose, edges: pg.EdgeSet, node_mask: torch.Tensor,
                       node_count: torch.Tensor, window: int, **kw) -> CapturedSolve:
        """The captured ``optimize_window`` of this window size with its
        inputs loaded (``node_count`` a 0-d int32 device tensor)."""
        def solve(x):
            nds, es, mask, count = _unpack(x)
            return pg.optimize_window(nds, es, mask, count, window, **kw)

        inputs = _inputs(nodes, edges, node_mask, node_count)
        key = ("window", window, tuple(sorted(kw.items())))
        g = self._get(key, inputs, solve, (pg.optimize_window, "calls"))
        g.load(inputs)
        return g

    def full(self, *args, **kw) -> Tuple[Pose, pg.SolveStats]:
        """:meth:`prepare_full`, then replay."""
        return self.prepare_full(*args, **kw).run()

    def window(self, *args, **kw) -> Tuple[Pose, pg.SolveStats]:
        """:meth:`prepare_window`, then replay."""
        return self.prepare_window(*args, **kw).run()


_BY_DEVICE: Dict[torch.device, CapturedSolves] = {}


def for_device(device) -> Optional[CapturedSolves]:
    """The process's captured solves for ``device`` (the inline solve's
    cache, as ``jax.jit`` keeps one per process); None on the CPU, where
    the solves run eagerly."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _BY_DEVICE:
        _BY_DEVICE[device] = CapturedSolves(device)
    return _BY_DEVICE[device]
