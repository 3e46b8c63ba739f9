"""A run's window and verdict on the CPU at a small size: sound, it
comes out correct; with the timed path broken underneath, not.

The card's look is skipped: the window (``drive.run_window``) and the
check (``bench.check``) run as in a run, on CPU tensors, where the
program's kernel wrappers take their plain versions.
"""

import copy

import numpy as np
import pytest
import torch

from icpslam_tpu_torch.pipeline import odometry, slam
from yardstick import bench, drive, layers, spec
from yardstick import traffic as tr

torch.set_num_threads(1)
SCANS = 6


@pytest.fixture(scope="module", params=["kitti_hdl64.revisit", "kitti_hdl64_deskew.one_way"])
def small(request):
    """A cell's configuration and traffic cut to a CPU test's size, its
    scans rendered from one seed."""
    cell = spec.load_cell(request.param, trace=False)
    config = copy.deepcopy(cell.config)
    config["slam"].update(max_points=1024, max_map_points=8192, voxel_leaf_size=0.8,
                          map_resolution=0.8, max_keyframes=64, max_edges=256, graph_window=8,
                          graph_bucket_min=8)
    # the cell's route driven open, so that a few scans make a sequence
    traffic = dict(cell.traffic, scans=SCANS, check_scans=SCANS,
                   route=dict(cell.traffic["route"], closed=False))
    scans = tr.render_sequence(traffic, config["sensor"], 2**32 + 5, 131072, workers=0).result()
    gt = tr.trajectory(traffic, config["sensor"], 2**32 + 5)
    return config, scans, (gt[0][0], gt[1][0])


def verdict(small, seconds=1.5, traced=False):
    config, scans, init = small
    cfg = drive.config_of(config)
    w = drive.run_window(cfg, scans, init, 10.0, seconds, "cpu", traced=traced, snap_at=SCANS)
    ok, rows, compared, _ = bench.check([w], scans, config["slam"], init, 10.0, SCANS, "cpu")
    assert compared >= SCANS and w.graphs and all(g[0] <= SCANS for g in w.graphs)
    return ok, dict((name, v) for name, v, _ in rows), w


def test_sound_run_is_correct(small):
    ok, nums, w = verdict(small)
    assert ok, nums
    assert len(w.replays) >= 1 and all(len(r) <= SCANS for r in w.replays)


def test_traced_run_is_correct_and_fills_the_spans(small):
    ok, nums, w = verdict(small, traced=True)
    assert ok, nums
    ctx = drive.context(w, 1.0)
    assert ctx.n > 0 and sum(ctx.spans["bench.odometry"][:ctx.n]) > 0.0
    assert len(ctx.implicit_syncs) == len(ctx.completions)
    outer = drive.context(w, 1.0, profiled=w)
    assert spec._reader("odometry_ms_per_scan", spec.BENCH_DIR)(outer) > 0.0


def test_traced_run_fills_the_program_spans_and_counts(small):
    """The profiled window runs under the program's tracing: each replay's
    spans and counters laid end to end along the window's scans, and the
    layer readers reading them."""
    ok, nums, w = verdict(small, traced=True)
    assert ok, nums
    outer = drive.context(w, 1.0, profiled=w)
    ctx = outer.profiled
    n, total = ctx.n, len(ctx.completions)
    assert n > 0 and {"slam.step", "odometry.step", "scan_to_map.refine"} <= set(ctx.program_spans)
    assert ctx.program_spans["odometry.step"]["parent"] == "slam.step"
    for table in (ctx.program_spans, ctx.program_counts):
        assert {len(v) for by in table.values() for v in by.values() if isinstance(v, list)} == {
            total}
    assert ctx.program_counts["host_syncs"]["total"] == ctx.host_syncs
    records = np.concatenate(w.replays)[:n]
    iterations = spec._reader("odometry_iterations_per_scan", spec.BENCH_DIR)(outer)
    assert iterations == pytest.approx(float(records[:, 10].mean())) and iterations > 0
    assert spec._reader("scan_to_map_iterations_per_scan", spec.BENCH_DIR)(outer) > 0
    # no implicit sync off the card; the layers' syncs and the rest sum to the window's
    assert sum(ctx.implicit_syncs) == 0 and ctx.implicit_by_span == {}
    got = layers.rollup(ctx)
    assert sum(v["syncs"] for k, v in got.items() if k != "window") == pytest.approx(
        got["window"]["syncs"]) and got["window"]["syncs"] > 0


def test_a_traced_window_names_a_span_target_that_is_gone(small, monkeypatch):
    monkeypatch.delattr(slam, "_optimize")
    with pytest.raises(RuntimeError, match="icpslam_tpu_torch.pipeline.slam._optimize"):
        verdict(small, traced=True)


def _state_unchanged(orig):
    def step(state, scan, config, stamp=None, mesh=None):
        _, out = orig(state, scan, config, stamp=stamp, mesh=mesh)
        return state, out
    return step


def _half_scan(orig):
    def step(state, scan, config, stamp=None, mesh=None):
        mask = scan.mask.clone()
        mask[1::2] = False  # every other return: the scans fill a prefix of their slots
        return orig(state, scan._replace(mask=mask), config, stamp=stamp, mesh=mesh)
    return step


def _odometry_altered(orig):
    def step(state, scan, config, *args, **kw):
        new, out = orig(state, scan, config, *args, **kw)
        moved = out.transform._replace(t=out.transform.t + torch.tensor([0.01, 0.0, 0.0]))
        return new, out._replace(transform=moved)
    return step


@pytest.mark.parametrize("fault", ["state_unchanged", "half_scan", "answer_altered"])
def test_a_broken_step_is_not_correct(small, fault, monkeypatch):
    """A step that returns its state unchanged; half of each scan's
    returns left out (this system's batch is the scan); the odometry's
    answer altered where it is produced."""
    if fault == "answer_altered":
        monkeypatch.setattr(odometry, "odometry_step", _odometry_altered(odometry.odometry_step))
    else:
        wrap = _state_unchanged if fault == "state_unchanged" else _half_scan
        monkeypatch.setattr(slam, "slam_step", wrap(slam.slam_step))
    ok, nums, _ = verdict(small)
    assert not ok, nums


def test_numbers_see_each_field():
    from yardstick import compare

    ref = np.zeros((4, 18), np.float32)
    ref[:, 3] = 1.0
    ref[:, 8] = 0.5
    q = np.tile(np.float32([1.0, 0.0, 0.0, 0.0]), (3, 1))
    kf = (3, np.zeros((3, 3), np.float32), q)
    graph, refs = (4,) + kf, {4: kf}
    assert compare.numbers([ref], ref, [graph], refs)[0] == dict(
        pose_gap_m=0.0, rot_gap_rad=0.0, fitness_gap=0.0, count_gap=0.0,
        decision_mismatches=0.0, graph_pose_gap_m=0.0, graph_rot_gap_rad=0.0)
    for col, key in ((1, "pose_gap_m"), (8, "fitness_gap"), (15, "count_gap"),
                     (12, "decision_mismatches")):
        bad = ref.copy()
        bad[2, col] += 1.0
        assert compare.numbers([ref, bad], ref, [graph], refs)[0][key] > 0.0
    bad = ref.copy()
    bad[1, 0] = np.nan
    nums, compared = compare.numbers([bad], ref, [graph], refs)
    assert compared == 4 and not compare.verdict(nums, compared)[0]
    assert not compare.verdict(compare.numbers([], ref, [], refs)[0], 0)[0]
    # the solved history: a moved keyframe, a turned one, a replay cut after
    # its second scan (held to the reference's graph there), another count,
    # no graph at all
    moved = (4, 3, kf[1] + np.float32([0.0, 0.01, 0.0]), q)
    turned = (4, 3, kf[1], np.float32([[1.0, 0.0, 0.0, 0.0]] * 2 + [[0.9999, 0.01, 0.0, 0.0]]))
    nums = compare.numbers([ref], ref, [graph, moved], refs)[0]
    assert nums["graph_pose_gap_m"] == pytest.approx(0.01) and nums["graph_rot_gap_rad"] == 0.0
    assert compare.numbers([ref], ref, [turned], refs)[0]["graph_rot_gap_rad"] > 0.0
    cut = (2, 2, kf[1][:2], q[:2])
    assert compare.numbers([ref], ref, [graph, cut], {**refs, 2: cut[1:]})[0]["graph_pose_gap_m"] == 0.0
    assert compare.numbers([ref], ref, [moved[:1] + cut[1:]], {**refs, 2: cut[1:]})[0][
        "graph_pose_gap_m"] == np.inf
    for graphs in ([(4, 2, kf[1][:2], q[:2])], []):
        nums = compare.numbers([ref], ref, graphs, refs)[0]
        assert nums["graph_pose_gap_m"] == np.inf and not compare.verdict(nums, 4)[0]
