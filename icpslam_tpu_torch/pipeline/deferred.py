"""Pipelined back end: the graph solve runs beside the stream (port of
``icpslam_tpu/pipeline/deferred.py``).

With ``config.defer_optimization`` the solve leaves ``slam_step``.
:class:`DeferredBackend` launches it on a snapshot of the graph once the
keyframe window fills and folds its result into the live state once it is
done, or after ``max_lag`` scans. On the card the launch is:

1. an event on the main stream, which a side stream waits on;
2. on the side stream, the copy of the live graph into the captured
   solve's static inputs (``graph/captured.py``) — that copy is the
   snapshot — and an event that the main stream waits on, so that the
   stream's next writes to the store come after it;
3. the graph's replay on the side stream and an event after it.

The main stream never waits for the solve until the fold, and then on the
device: the host decides with ``event.query()``, which does not block.
The trigger needs no device read either: ``slam_step`` hands its host
counters over on ``SlamOutput.host``.

The trigger keeps JAX's schedule call for call. JAX arms an asynchronous
read of ``kf_since_opt`` on one call, reads it on a later one and launches
with that later call's state; the call that folds arms nothing. Here the
value armed is the step's host counter, and it is read on the next call,
which is JAX's schedule at ``max_lag=0`` (a probe read on the call after
it was armed, whatever the device).

**Divergence from JAX.** JAX's fold writes the solve's pose ``i`` into
store slot ``i`` for every ``i < snapshot_count``. Marginalisation compacts
the store and moves every keyframe above the victim down by one slot, so
after an eviction during the solve that puts poses on their neighbours.
Here :func:`fold` takes the victims evicted since the launch (their
indices come with the step's edge-count read) and puts each snapshot pose
on its own keyframe, wherever compaction moved it; a snapshot keyframe
that was evicted takes nothing. The window then restarts from the
keyframes that took no snapshot pose. Without an eviction the fold is
JAX's.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch

from icpslam_tpu_torch.geometry import se3
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.graph import captured as captured_mod
from icpslam_tpu_torch.mapping import backend as map_backend
from icpslam_tpu_torch.pipeline import slam
from icpslam_tpu_torch.utils.sync import to_host


class SnapshotSolve(NamedTuple):
    nodes: Pose                  # (K,) optimized graph poses (snapshot prefix live)
    map_to_odom: Pose            # correction at the snapshot's last keyframe
    final_cost: torch.Tensor
    snapshot_count: torch.Tensor  # int32 keyframes included in the solve
    snapshot_lc: torch.Tensor     # int32 lc_since_opt the solve consumed


def solve_snapshot(state: slam.SlamState, config, counts: dict, captured=None,
                   copied=None, mesh=None) -> SnapshotSolve:
    """The graph solve on a snapshot of the live graph: the full solve when
    a loop closure arrived since the last solve (or without
    ``graph_incremental``), the window solve otherwise, as JAX's
    ``solve_snapshot`` chooses. ``counts``: the host values of the keyframe,
    edge and loop-since-last-solve counters (``SlamOutput.host``).
    ``captured``, ``copied`` and ``mesh`` as in ``slam.graph_solve``."""
    store = state.keyframes
    full = not config.graph_incremental or counts["lc_since_opt"] > 0
    last = torch.clamp(store.count - 1, min=0).long()
    last_odom = se3.index(store.pose_odom, last)
    snap_count, snap_lc = store.count.clone(), state.lc_since_opt.clone()
    nodes, stats = slam.graph_solve(state, config, counts, full, captured, copied, mesh=mesh)
    m2o = se3.normalize(se3.compose(se3.index(nodes, last), se3.inverse(last_odom)))
    return SnapshotSolve(nodes=nodes, map_to_odom=m2o, final_cost=stats.final_cost,
                         snapshot_count=snap_count, snapshot_lc=snap_lc)


def fold(state: slam.SlamState, solve: SnapshotSolve, config,
         evicted: Sequence[int] = ()) -> slam.SlamState:
    """Merge a snapshot solve into the live state.

    Each snapshot keyframe takes its optimized pose, in the slot it holds
    now: ``evicted`` lists the keyframe indices marginalized out since the
    snapshot, in order, and each moved the keyframes above it down by one.
    Keyframes created since are re-based as ``new_m2o ∘ pose_in_odom``, the
    composition that created them (``icpslam.cpp:76-77``). The map is
    reset (unless disabled) and the window restarts from the keyframes
    the solve did not see; loop closures that arrived after the snapshot
    stay pending, so the next solve is a full one.
    """
    store = state.keyframes
    K = store.capacity
    dev = store.count.device
    ids = torch.arange(K, device=dev)
    slot = ids
    for v in evicted:
        slot = torch.where(slot == v, -1, torch.where(slot > v, slot - 1, slot))
    took = (ids < solve.snapshot_count) & (slot >= 0)
    # snapshot keyframes that no longer exist go to a spare row K
    slot = torch.where(took, slot, K)

    def place(x, fill):
        return fill.new_zeros((K + 1,) + fill.shape[1:]).index_copy(0, slot, x)[:K]

    in_snap = place(took, took)
    snap_t = place(solve.nodes.t, store.pose_graph.t)
    snap_q = place(solve.nodes.q, store.pose_graph.q)
    live = ids < store.count
    m2o = solve.map_to_odom
    rebased = se3.compose(m2o, store.pose_odom)
    new_graph = Pose(
        t=torch.where(in_snap[:, None], snap_t,
                      torch.where(live[:, None], rebased.t, store.pose_graph.t)),
        q=torch.where(in_snap[:, None], snap_q,
                      torch.where(live[:, None], rebased.q, store.pose_graph.q)),
    )
    new_map = map_backend.reset(state.map) if config.reset_map_on_optimize else state.map
    return state._replace(
        keyframes=store._replace(pose_graph=new_graph),
        map=new_map,
        map_to_odom=m2o,
        kf_since_opt=(store.count - took.sum(dtype=torch.int32)).to(torch.int32),
        lc_since_opt=torch.clamp(state.lc_since_opt - solve.snapshot_lc, min=0).to(torch.int32),
        num_optimizations=state.num_optimizations + 1,
    )


class DeferredBackend:
    """Host-side control of the pipelined solve.

    Call ``maybe_launch_or_fold(state, out)`` after every ``slam_step``
    (``out`` is the step's ``SlamOutput``). Every ``check_every`` calls
    without a solve in flight it arms the trigger with
    ``out.host.kf_since_opt``; on the next call it launches a solve on
    that call's state if the armed value had filled the window
    (``>= keyframes_window``). With a solve in flight it folds it on the
    first call that finds it done, or after ``max_lag`` calls (the
    bounded-staleness guarantee; on the card the main stream then waits
    for the solve on the device, the host does not), and arms nothing on
    that call.
    ``flush`` folds what is pending at the end of the stream and runs a
    solve that is due. On the card the solves replay CUDA graphs (Schur
    excepted) on a side stream; on the CPU they run eagerly at the launch.
    ``captured``: the ``graph/captured.CapturedSolves`` to replay from
    (default: the backend's own, made at its first call on the card).
    ``mesh``: the mesh a ``dist-*`` solver shards the solve over (required
    for those, as in JAX).
    """

    def __init__(self, config, max_lag: int = 8, check_every: int = 1, captured=None,
                 mesh=None):
        if not config.defer_optimization:
            raise ValueError("config.defer_optimization must be True")
        if config.graph_linear_solver.startswith("dist-") and mesh is None:
            raise ValueError(
                f"graph_linear_solver='{config.graph_linear_solver}' "
                "requires mesh= (the deferred solve runs edge-sharded)"
            )
        slam.check_supported(config)
        self.config = config
        self.mesh = mesh
        self.max_lag = max_lag
        self.check_every = max(1, check_every)
        self._device: Optional[torch.device] = None
        self.captured = captured
        self._side = None
        self._done = None
        self._pending: Optional[SnapshotSolve] = None
        self._evicted: List[int] = []
        self._age = 0
        self._since_check = 0
        self._armed: Optional[int] = None  # kf_since_opt when the trigger was armed
        self._calls = 0
        self.num_launched = 0
        self.num_folded = 0
        self.launched_at: List[int] = []   # call index (0-based) of each launch
        self.folded_at: List[int] = []     # and of each fold
        self.folds_across_eviction = 0
        self.capture_calls: List[int] = []  # calls whose launch captured a graph

    def _bind(self, device: torch.device) -> None:
        if self._device is not None:
            if device != self._device:
                raise ValueError(f"DeferredBackend bound to {self._device}, got a state on {device}")
            return
        self._device = device
        if device.type == "cuda":
            if self.captured is None:
                self.captured = captured_mod.CapturedSolves(device)
            self._side = torch.cuda.Stream(device)

    def _launch(self, state: slam.SlamState, counts: dict) -> None:
        if self._side is None:
            self._pending = solve_snapshot(state, self.config, counts, mesh=self.mesh)
        else:
            n_graphs = len(self.captured.graphs)
            main = torch.cuda.current_stream(self._device)
            copied = torch.cuda.Event()
            self._side.wait_stream(main)
            with torch.cuda.stream(self._side):
                self._pending = solve_snapshot(state, self.config, counts, self.captured, copied,
                                               mesh=self.mesh)
                self._done = torch.cuda.Event()
                self._done.record()
            # the stream's next writes to the store come after the snapshot
            main.wait_event(copied)
            if len(self.captured.graphs) > n_graphs:
                self.capture_calls.append(self._calls)
        self._evicted, self._age = [], 0
        self.num_launched += 1
        self.launched_at.append(self._calls)

    def _ready(self) -> bool:
        return self._done is None or self._done.query()

    def _fold(self, state: slam.SlamState) -> slam.SlamState:
        solve = self._pending
        if self._side is not None:
            main = torch.cuda.current_stream(self._device)
            main.wait_event(self._done)
            for x in (*solve.nodes, *solve.map_to_odom, solve.final_cost,
                      solve.snapshot_count, solve.snapshot_lc):
                x.record_stream(main)
        state = fold(state, solve, self.config, self._evicted)
        self.folds_across_eviction += bool(self._evicted)
        self._pending, self._done, self._evicted = None, None, []
        self.num_folded += 1
        self.folded_at.append(self._calls)
        return state

    def maybe_launch_or_fold(self, state: slam.SlamState, out: slam.SlamOutput) -> slam.SlamState:
        self._bind(state.keyframes.count.device)
        host = out.host
        try:
            if self._pending is not None:
                if host.evicted >= 0:
                    self._evicted.append(host.evicted)
                self._age += 1
                if self._age >= self.max_lag or self._ready():
                    state = self._fold(state)
                return state
            if self._armed is not None:
                due = self._armed >= self.config.keyframes_window
                self._armed = None
                if due:
                    self._launch(state, host._asdict())
                    return state
            self._since_check += 1
            if self._since_check >= self.check_every:
                self._since_check = 0
                self._armed = host.kf_since_opt
            return state
        finally:
            self._calls += 1

    def flush(self, state: slam.SlamState) -> slam.SlamState:
        """Fold any pending solve; then, if the window has filled with no
        solve in flight, run the due solve and fold it (end-of-stream parity
        with the inline back end). One counted host read."""
        self._bind(state.keyframes.count.device)
        if self._pending is not None:
            state = self._fold(state)
        self._armed = None
        kf_since, n_kf, n_edges, lc_since = (int(v) for v in to_host(torch.stack([
            state.kf_since_opt, state.keyframes.count, state.edges.count, state.lc_since_opt,
        ])))
        if kf_since >= self.config.keyframes_window:
            counts = dict(keyframes=n_kf, edges=min(n_edges, state.edges.capacity),
                          lc_since_opt=lc_since)
            solve = solve_snapshot(state, self.config, counts, self.captured, mesh=self.mesh)
            state = fold(state, solve, self.config)
            self.num_launched += 1
            self.num_folded += 1
        return state
