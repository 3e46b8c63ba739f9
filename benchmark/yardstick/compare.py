"""The comparison that decides ``correct``.

Every replay of the window starts from a fresh state on the same scans,
so the scans ``[0, check_scans)`` of each replay are compared with the
reference's records of the same scans (the per-scan (18,) record:
``[t(3) | q(4) | accepted, fitness, correspondences, icp iterations,
refined, new keyframe, loop closures, optimized, map size, keyframes,
graph cost]``). The numbers, each the worst over every compared scan of
every replay:

- ``pose_gap_m``: the map-frame position's distance to the reference's;
- ``rot_gap_rad``: the map-frame rotation's angle to the reference's;
- ``fitness_gap``: the registration's fitness against the reference's,
  relative to it;
- ``count_gap``: the correspondences and the map's size, as counts;
- ``decision_mismatches``: scans whose accept, refine, keyframe,
  loop-closure or solve decision, or keyframe count, differ;
- ``graph_pose_gap_m``, ``graph_rot_gap_rad``: each replay's graph, its
  keyframe poses (the solved history), after scan ``check_scans`` or its
  last scan where the window cut it short, against the reference's after
  the same scan, worst over every keyframe; a different keyframe count,
  or no graph to compare, reads inf.

The limits and the readings they were set from are in ``PERF.md``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

# each between the sound runs' readings (the system equals the reference
# bit for bit: 0) and the TF32 control's least over every cell (PERF.md §4)
LIMITS = {
    "pose_gap_m": 8.0e-5,
    "rot_gap_rad": 2.0e-6,
    "fitness_gap": 3.0e-7,
    "count_gap": 0.0,
    "decision_mismatches": 0.0,
    "graph_pose_gap_m": 8.0e-5,
    "graph_rot_gap_rad": 2.0e-6,
}

DECISIONS = (7, 11, 12, 13, 14, 16)
COUNTS = (9, 15)


def _rot_gap(qa: np.ndarray, qb: np.ndarray) -> np.ndarray:
    """The rotation angle between unit-normalised wxyz quaternions, row by
    row: 4 asin(|qa - qb| / 2), the sign of qb matched to qa."""
    qa = qa / np.linalg.norm(qa, axis=1, keepdims=True)
    qb = qb / np.linalg.norm(qb, axis=1, keepdims=True)
    qb = qb * np.where(np.sum(qa * qb, axis=1) < 0.0, -1.0, 1.0)[:, None]
    chord = np.clip(np.linalg.norm(qa - qb, axis=1) / 2.0, 0.0, 1.0)
    return 4.0 * np.arcsin(chord)


def graph_gaps(graphs: Sequence[tuple], ref_graphs: Dict[int, tuple]) -> Tuple[float, float]:
    """(position, rotation) gaps of the graphs' keyframe poses, each
    ``(step, count, t (count, 3), q (count, 4))``, to the reference's
    after the same step (``ref_graphs[step]``: ``(count, t, q)``)."""
    if not graphs:
        return float("inf"), float("inf")
    pose = rot = 0.0
    for step, n, t, q in graphs:
        n_ref, t_ref, q_ref = ref_graphs[step]
        if n != n_ref:
            return float("inf"), float("inf")
        if n == 0:
            continue
        a, b = np.asarray(t, np.float64), np.asarray(t_ref, np.float64)
        gap = np.linalg.norm(a - b, axis=1).max()
        turn = _rot_gap(np.asarray(q, np.float64), np.asarray(q_ref, np.float64)).max()
        if not (np.isfinite(gap) and np.isfinite(turn)):
            return float("inf"), float("inf")
        pose, rot = max(pose, float(gap)), max(rot, float(turn))
    return pose, rot


def numbers(replays: Sequence[np.ndarray], ref: np.ndarray, graphs: Sequence[tuple],
            ref_graphs: Dict[int, tuple]) -> Tuple[Dict[str, float], int]:
    """The comparison's numbers over the replays' first ``len(ref)``
    records and the graph snapshots, and how many scans were compared."""
    pose = rot = fit = count = 0.0
    mismatches, compared = 0, 0
    for rec in replays:
        k = min(len(rec), len(ref))
        if k == 0:
            continue
        a, b = np.asarray(rec[:k], np.float64), np.asarray(ref[:k], np.float64)
        compared += k
        pose = max(pose, float(np.linalg.norm(a[:, :3] - b[:, :3], axis=1).max()))
        rot = max(rot, float(_rot_gap(a[:, 3:7], b[:, 3:7]).max()))
        # an unregistered scan's fitness is inf on both sides
        fa, fb = a[:, 8], b[:, 8]
        live = np.isfinite(fa) & np.isfinite(fb)
        if (np.isfinite(fa) != np.isfinite(fb)).any():
            fit = float("inf")
        elif live.any():
            fit = max(fit, float((np.abs(fa[live] - fb[live]) / np.maximum(np.abs(fb[live]), 1e-6)).max()))
        count = max(count, float(np.abs(a[:, COUNTS] - b[:, COUNTS]).max()))
        mismatches += int((a[:, DECISIONS] != b[:, DECISIONS]).any(axis=1).sum())
        if not np.isfinite(a[:, :7]).all():
            pose = rot = float("inf")
    graph_pose, graph_rot = graph_gaps(graphs, ref_graphs)
    nums = dict(pose_gap_m=pose, rot_gap_rad=rot, fitness_gap=fit, count_gap=count,
                decision_mismatches=float(mismatches), graph_pose_gap_m=graph_pose,
                graph_rot_gap_rad=graph_rot)
    return nums, compared


def verdict(nums: Dict[str, float], compared: int) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """(correct, [(name, number, limit)]): every number within its limit,
    and at least one scan compared."""
    rows = [(k, float(nums[k]), LIMITS[k]) for k in LIMITS]
    ok = compared > 0 and all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
