"""The generator's copy against the system's generator, at small sizes."""

import numpy as np
import pytest

from icpslam_tpu_torch.io import synthetic
from yardstick import traffic as tr

SMALL_WORLD = dict(blocks=2, block_size=30.0, street_width=18.0, height=12.0,
                   ground_density=1.0, wall_density=3.0, n_poles=20)


def test_world_and_objects_are_the_systems():
    a = synthetic.make_urban_world(seed=5, **SMALL_WORLD)
    b = tr.make_urban_world(seed=5, **SMALL_WORLD)
    np.testing.assert_array_equal(a, b)
    fa = synthetic.make_moving_objects(seed=3, blocks=2, block_size=30.0)
    fb = tr.make_moving_objects(seed=3, blocks=2, block_size=30.0)
    np.testing.assert_array_equal(fa(1.3), fb(1.3))


@pytest.mark.parametrize("block", [40.0, 80.0])
def test_closed_block_route_is_the_urban_drive(block):
    a = synthetic.make_urban_drive(n_poses=600, block_size=block)
    b = tr.route_drive([[0, 0], [1, 0], [1, 1], [0, 1]], True, 600, block_size=block)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_open_route_turns_both_ways_and_ends():
    t, q = tr.route_drive([[0, 0], [1, 0], [1, 1], [0, 1], [0, 2]], False, 300)
    step = np.linalg.norm(np.diff(t[:, :2], axis=0), axis=1)
    # 8 m/s at 10 Hz; at a corner the leftover of a leg adds under one step,
    # as in the system's make_urban_drive
    assert step.max() < 2.1 * 0.8
    assert np.allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-6)
    with pytest.raises(ValueError, match="open route ends"):
        tr.route_drive([[0, 0], [1, 0]], False, 1000)


@pytest.mark.parametrize("physics", [False, True])
def test_render_is_the_systems(physics):
    world = tr.make_urban_world(seed=1, **SMALL_WORLD)
    t, q = tr.route_drive([[0, 0], [1, 0], [1, 1], [0, 1]], True, 4, block_size=30.0)
    kw = dict(n_beams=16, azimuth_bins=256, max_range=40.0)
    if physics:
        kw.update(noise_range_coeff=3e-4, dropout=0.08, next_pose_t=t[1], next_pose_q=q[1])
    a = synthetic.render_velodyne_scan(world, t[0], q[0], seed=9, max_points=4096, **kw)
    b = tr.render_velodyne_scan(world, t[0], q[0], seed=9, max_points=4096, **kw)
    assert a.shape[0] > 100
    np.testing.assert_array_equal(a, b)


SENSOR = {"n_beams": 16, "azimuth_bins": 256, "elevation_range": [-24.8, 2.0],
          "max_range": 40.0, "min_range": 2.5, "noise": 0.02, "rate_hz": 10.0, "physics": None}


def test_open_route_sequence_is_the_runners_stream_and_follows_the_seed():
    """On an open route ``render_sequence`` with the traffic's scene seed
    and a run's noise seed gives the system's ``velodyne_stream`` of the
    same drive, in workers or not; another run seed, other scans in the
    same world."""
    traffic = {"world": SMALL_WORLD, "route": {"waypoints": [[0, 0], [1, 0], [1, 1]],
                                               "closed": False},
               "scene_seed": 4, "scans": 3, "speed": 8.0, "z": 1.7}
    seed = 2**33 + 17
    here = tr.render_sequence(traffic, SENSOR, seed, 8192, workers=0).result()
    pooled = tr.render_sequence(traffic, SENSOR, seed, 8192, workers=2).result()
    world_seed, scan_seed = tr.seeds(4)[0], tr.seeds(seed)[1]
    assert tr.order(traffic, SENSOR, seed) == (0, scan_seed)
    world = synthetic.make_urban_world(seed=world_seed, **SMALL_WORLD)
    gt = tr.trajectory(traffic, SENSOR, seed)
    stream = synthetic.velodyne_stream(world, gt, 8192, seed=scan_seed, n_beams=16,
                                       azimuth_bins=256, max_range=40.0)
    for a, b, ((p, m), _) in zip(here, pooled, stream):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, p[m])
    other = tr.render_sequence(traffic, SENSOR, seed + 1, 8192, workers=0).result()
    assert not np.array_equal(here[0], other[0])


def test_closed_route_seeds_drive_the_same_scans_in_another_order():
    """Every seed gets the same whole laps of scans, started elsewhere."""
    route = {"waypoints": [[0, 0], [1, 0], [1, 1], [0, 1]], "closed": True}
    lap = tr.lap_poses(route["waypoints"], **SMALL_WORLD)
    full = tr.route_drive(route["waypoints"], True, 2 * lap, **SMALL_WORLD)[0]
    np.testing.assert_allclose(full[:lap], full[lap:], atol=1e-4)  # a lap is a period
    traffic = {"world": SMALL_WORLD, "route": route, "scene_seed": 4, "scans": lap,
               "speed": 8.0, "z": 1.7}
    a, b = 11, 12
    ka, kb = tr.order(traffic, SENSOR, a)[0], tr.order(traffic, SENSOR, b)[0]
    assert ka != kb
    sa = tr.render_sequence(traffic, SENSOR, a, 8192, workers=2).result()
    sb = tr.render_sequence(traffic, SENSOR, b, 8192, workers=2).result()
    for i in (0, 5, lap - 1):
        np.testing.assert_array_equal(sa[i], sb[(i + ka - kb) % lap])
    ta = tr.trajectory(traffic, SENSOR, a)[0]
    np.testing.assert_allclose(ta[0], full[ka], atol=1e-5)
    with pytest.raises(ValueError, match="whole laps"):
        tr.order(dict(traffic, scans=lap + 1), SENSOR, a)
