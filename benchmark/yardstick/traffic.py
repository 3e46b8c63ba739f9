"""The traffic generator: the urban proxy of KITTI's HDL-64E, numpy only.

A copy of the system's generator (``icpslam_tpu_torch/io/synthetic.py``:
``make_urban_world``, ``make_urban_drive``, ``render_velodyne_scan``,
``make_moving_objects``, ``pad``), kept here so that a change to the
system cannot move the yardstick; ``tests/test_bench_traffic.py`` holds it
to the original. Beside it, :func:`route_drive` generalises the drive
around one block to any route through the street grid's intersections,
and :func:`render_sequence` renders a traffic file's sequence from a seed
in worker processes.

A traffic file (``benchmark/traffic/<name>.json``) holds parameters only:
``world`` (``make_urban_world`` keywords), ``route`` (``waypoints`` as
``[i, j]`` intersection indices of the grid and ``closed``), ``scene_seed``
(the world's layout and the moving objects), ``scans``, ``speed`` (m/s),
``z`` (the body height) and ``check_scans`` (the prefix the reference
replays, and the scan after which the graph is compared). A run's seed picks
where a closed route's fixed scans start, or draws an open route's
scan noise (:func:`order`). The
sensor and its physics come from the configuration file's ``sensor``.
This module imports numpy alone, so the render workers start fast.
"""

from __future__ import annotations

import gc
import multiprocessing
from multiprocessing import resource_tracker
from typing import List, Optional, Sequence, Tuple

import numpy as np

Trajectory = Tuple[np.ndarray, np.ndarray]  # (t (T, 3), q (T, 4) wxyz) float32

def pad(points: np.ndarray, capacity: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad (n, 3) points into a fixed-capacity (points, mask) pair."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"{n} points exceed capacity {capacity}")
    buf = np.zeros((capacity, 3), np.float32)
    buf[:n] = points
    mask = np.zeros((capacity,), bool)
    mask[:n] = True
    return buf, mask

def _yaw_quats(yaw: np.ndarray) -> np.ndarray:
    return np.stack(
        [np.cos(yaw / 2), np.zeros_like(yaw), np.zeros_like(yaw), np.sin(yaw / 2)],
        axis=-1,
    )

def make_urban_world(
    seed: int = 0,
    blocks: int = 3,
    block_size: float = 80.0,
    street_width: float = 18.0,
    height: float = 12.0,
    ground_density: float = 3.0,
    wall_density: float = 9.0,
    n_poles: int = 200,
) -> np.ndarray:
    """KITTI-proxy urban world: ground, facades and poles at velodyne scale."""
    rng = np.random.RandomState(seed)
    pitch = block_size + street_width
    extent = blocks * pitch + street_width
    parts = []
    n_ground = int(extent * extent * ground_density)
    parts.append(np.c_[rng.uniform(0, extent, (n_ground, 2)), np.zeros(n_ground)])
    for bx in range(blocks):
        for by in range(blocks):
            x0 = street_width + bx * pitch
            y0 = street_width + by * pitch
            x1, y1 = x0 + block_size, y0 + block_size
            h = rng.uniform(0.5, 1.0) * height
            n_wall = int(block_size * h * wall_density)
            rough = lambda n: rng.randn(n).astype(np.float64) * 0.03
            parts.extend([
                np.c_[rng.uniform(x0, x1, n_wall), np.full(n_wall, y0) + rough(n_wall),
                      rng.uniform(0, h, n_wall)],
                np.c_[rng.uniform(x0, x1, n_wall), np.full(n_wall, y1) + rough(n_wall),
                      rng.uniform(0, h, n_wall)],
                np.c_[np.full(n_wall, x0) + rough(n_wall), rng.uniform(y0, y1, n_wall),
                      rng.uniform(0, h, n_wall)],
                np.c_[np.full(n_wall, x1) + rough(n_wall), rng.uniform(y0, y1, n_wall),
                      rng.uniform(0, h, n_wall)],
            ])
    pts_per_pole = 150
    px = rng.uniform(0, extent, n_poles)
    py = rng.uniform(0, extent, n_poles)
    for i in range(n_poles):
        z = rng.uniform(0, 5.0, pts_per_pole)
        th = rng.uniform(0, 2 * np.pi, pts_per_pole)
        parts.append(np.c_[px[i] + 0.15 * np.cos(th), py[i] + 0.15 * np.sin(th), z])
    return np.concatenate(parts).astype(np.float32)

def make_urban_drive(
    n_poses: int = 500,
    blocks: int = 3,
    block_size: float = 80.0,
    street_width: float = 18.0,
    speed: float = 8.0,
    rate_hz: float = 10.0,
    z: float = 1.7,
) -> Trajectory:
    """10 Hz drive around the first city block with rounded corners."""
    half = street_width / 2.0
    c0 = half
    c1 = street_width + block_size + half
    corner_r = min(6.0, half * 0.9 + 2.0)
    corners = np.array([[c0, c0], [c1, c0], [c1, c1], [c0, c1]], np.float64)
    step = speed / rate_hz
    pts, yaws = [], []
    i = 0
    while len(pts) < n_poses:
        a = corners[i % 4]
        b = corners[(i + 1) % 4]
        c = corners[(i + 2) % 4]
        d1 = (b - a) / np.linalg.norm(b - a)
        d2 = (c - b) / np.linalg.norm(c - b)
        seg_len = np.linalg.norm(b - a) - 2 * corner_r
        n_seg = max(int(seg_len / step), 1)
        for k in range(n_seg):
            if len(pts) >= n_poses:
                break
            p = a + d1 * (corner_r + k * step)
            pts.append([p[0], p[1], z])
            yaws.append(np.arctan2(d1[1], d1[0]))
        center = b - d1 * corner_r + d2 * corner_r
        yaw0 = np.arctan2(d1[1], d1[0])
        arc_len = np.pi / 2 * corner_r
        n_arc = max(int(arc_len / step), 1)
        for k in range(n_arc):
            if len(pts) >= n_poses:
                break
            th = (k + 0.5) / n_arc * (np.pi / 2)
            start = b - d1 * corner_r
            rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
            p = center + rot @ (start - center)
            pts.append([p[0], p[1], z])
            yaws.append(yaw0 + th)
        i += 1
    pos = np.asarray(pts, np.float64)
    yaw = np.asarray(yaws, np.float64)
    return pos.astype(np.float32), _yaw_quats(yaw).astype(np.float32)

def _quat_slerp_np(q0: np.ndarray, q1: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Slerp q0→q1 at fractions u (n,) → (n, 4), wxyz, float64."""
    q0 = q0 / np.linalg.norm(q0)
    q1 = q1 / np.linalg.norm(q1)
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:  # nearly parallel: lerp + renorm
        out = q0[None, :] + u[:, None] * (q1 - q0)[None, :]
        return out / np.linalg.norm(out, axis=-1, keepdims=True)
    th = np.arccos(np.clip(d, -1, 1))
    s = np.sin(th)
    a = np.sin((1 - u) * th) / s
    b = np.sin(u * th) / s
    return a[:, None] * q0[None, :] + b[:, None] * q1[None, :]

def _quat_rot_np(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    uv = 2.0 * np.cross(q[:, 1:], v)
    return v + q[:, 0:1] * uv + np.cross(q[:, 1:], uv)

def render_velodyne_scan(
    world: np.ndarray,
    pose_t: np.ndarray,
    pose_q: np.ndarray,
    n_beams: int = 64,
    azimuth_bins: int = 2048,
    elevation_range: Tuple[float, float] = (-24.8, 2.0),
    max_range: float = 80.0,
    min_range: float = 2.5,
    noise: float = 0.02,
    noise_range_coeff: float = 0.0,
    dropout: float = 0.0,
    seed: int = 0,
    max_points: Optional[int] = None,
    next_pose_t: Optional[np.ndarray] = None,
    next_pose_q: Optional[np.ndarray] = None,
    return_times: bool = False,
):
    """64-beam spinning lidar with a spherical z-buffer (nearest return per
    beam × azimuth cell): (n, 3) float32 in the sweep-start sensor frame,
    and with ``return_times`` the per-point sweep fraction (n,) float32.

    The defaults are the idealized render. ``next_pose_t/q`` re-measure
    each hit from the sensor pose interpolated (lerp, slerp) to its
    azimuth's capture time (motion distortion); the noise along the ray
    has σ(r) = ``noise`` + ``noise_range_coeff``·r; each return is lost
    with probability ``dropout``."""
    rng = np.random.RandomState(seed)
    d = np.linalg.norm(world - np.asarray(pose_t, np.float32)[None, :], axis=-1)
    near = world[(d <= max_range) & (d >= min_range * 0.5)]
    q_np = np.asarray(pose_q, np.float64)
    q_conj0 = np.r_[q_np[0], -q_np[1:]] / np.linalg.norm(q_np)
    local = _quat_rot_np(
        q_conj0[None, :], near.astype(np.float64) - np.asarray(pose_t, np.float64)
    ).astype(np.float32)
    r = np.linalg.norm(local, axis=-1)
    keep = (r >= min_range) & (r <= max_range)
    local, r, near = local[keep], r[keep], near[keep]
    az = np.arctan2(local[:, 1], local[:, 0])
    el = np.degrees(np.arcsin(np.clip(local[:, 2] / np.maximum(r, 1e-9), -1, 1)))
    lo, hi = elevation_range
    beam = np.floor((el - lo) / (hi - lo) * n_beams).astype(np.int64)
    in_fov = (beam >= 0) & (beam < n_beams)
    abin = np.floor((az + np.pi) / (2 * np.pi) * azimuth_bins).astype(np.int64)
    abin = np.clip(abin, 0, azimuth_bins - 1)
    local, r, beam, abin = local[in_fov], r[in_fov], beam[in_fov], abin[in_fov]
    world_pts = near[in_fov]
    cell = beam * azimuth_bins + abin
    order = np.lexsort((r, cell))
    cell_sorted = cell[order]
    first = np.ones(cell_sorted.shape[0], bool)
    first[1:] = cell_sorted[1:] != cell_sorted[:-1]
    hits = local[order][first]
    rr = r[order][first]
    world_hits = world_pts[order][first]
    frac = (abin[order][first].astype(np.float64) + 0.5) / azimuth_bins
    if next_pose_t is not None:
        # each world hit seen from the sensor pose at its capture time,
        # expressed in the sweep-start frame
        u = frac
        t_interp = (
            np.asarray(pose_t, np.float64)[None, :] * (1 - u[:, None])
            + np.asarray(next_pose_t, np.float64)[None, :] * u[:, None]
        )
        q_interp = _quat_slerp_np(
            np.asarray(pose_q, np.float64), np.asarray(next_pose_q, np.float64), u
        )
        q_conj = np.c_[q_interp[:, 0], -q_interp[:, 1:]]
        hits = _quat_rot_np(q_conj, world_hits.astype(np.float64) - t_interp)
        rr = np.linalg.norm(hits, axis=-1)
    if noise or noise_range_coeff:
        sigma = noise + noise_range_coeff * rr
        scale = 1.0 + rng.randn(hits.shape[0]) * sigma / np.maximum(rr, 1e-6)
        hits = hits * scale[:, None]
    if dropout:
        keep_m = rng.uniform(size=hits.shape[0]) >= dropout
        hits, frac = hits[keep_m], frac[keep_m]
    if max_points is not None and hits.shape[0] > max_points:
        sel = rng.choice(hits.shape[0], max_points, replace=False)
        hits, frac = hits[sel], frac[sel]
    hits = hits.astype(np.float32)
    if return_times:
        return hits, frac.astype(np.float32)
    return hits

def make_moving_objects(
    seed: int = 0,
    n_vehicles: int = 6,
    blocks: int = 3,
    block_size: float = 80.0,
    street_width: float = 18.0,
    speed_range: Tuple[float, float] = (5.0, 12.0),
    pts_per_vehicle: int = 900,
):
    """Box-shaped vehicles (4.5 × 1.8 × 1.6 m shells) driving along the
    street grid: a callable ``t -> (n, 3) float32`` of their points at
    time ``t`` seconds."""
    rng = np.random.RandomState(seed)
    pitch = block_size + street_width
    extent = blocks * pitch + street_width
    half = street_width / 2.0
    lanes = [street_width + k * pitch - half for k in range(blocks + 1)]
    vehicles = []
    for _ in range(n_vehicles):
        along_x = bool(rng.randint(2))
        lane = lanes[rng.randint(len(lanes))] + rng.uniform(-2.0, 2.0)
        speed = rng.uniform(*speed_range) * (1 if rng.randint(2) else -1)
        phase = rng.uniform(0, extent)
        n = pts_per_vehicle
        face = rng.randint(0, 5, n)
        lx = rng.uniform(-2.25, 2.25, n)
        ly = rng.uniform(-0.9, 0.9, n)
        lz = rng.uniform(0.0, 1.6, n)
        lx = np.where(face == 0, -2.25, np.where(face == 1, 2.25, lx))
        ly = np.where(face == 2, -0.9, np.where(face == 3, 0.9, ly))
        lz = np.where(face == 4, 1.6, lz)
        vehicles.append((along_x, lane, speed, phase, np.c_[lx, ly, lz]))

    def at_time(t: float) -> np.ndarray:
        parts = []
        for along_x, lane, speed, phase, box in vehicles:
            pos = (phase + speed * t) % extent
            if along_x:
                parts.append(box + np.array([pos, lane, 0.0]))
            else:
                # the box turned 90° for cross-street travel
                parts.append(np.c_[box[:, 1], box[:, 0], box[:, 2]] + np.array([lane, pos, 0.0]))
        return np.concatenate(parts).astype(np.float32)

    return at_time



def route_drive(
    waypoints: Sequence[Sequence[int]],
    closed: bool,
    n_poses: int,
    block_size: float = 80.0,
    street_width: float = 18.0,
    speed: float = 8.0,
    rate_hz: float = 10.0,
    z: float = 1.7,
    **_world,
) -> Trajectory:
    """A drive along the street centrelines through the intersections
    ``waypoints`` (``[i, j]`` grid indices), with ``make_urban_drive``'s
    rounded corners and steps; a closed route repeats, an open one must be
    long enough for ``n_poses``. The closed route ``[[0, 0], [1, 0], [1, 1],
    [0, 1]]`` is ``make_urban_drive`` itself."""
    half = street_width / 2.0
    pitch = block_size + street_width
    corners = np.array([[half + i * pitch, half + j * pitch] for i, j in waypoints], np.float64)
    n_wp = corners.shape[0]
    if n_wp < 2:
        raise ValueError("a route needs two waypoints or more")
    corner_r = min(6.0, half * 0.9 + 2.0)
    step = speed / rate_hz
    pts, yaws = [], []
    i = 0
    while len(pts) < n_poses:
        if not closed and i + 1 >= n_wp:
            raise ValueError(f"the open route ends after {len(pts)} poses; {n_poses} asked")
        a = corners[i % n_wp]
        b = corners[(i + 1) % n_wp]
        turn = closed or i + 2 < n_wp
        d1 = (b - a) / np.linalg.norm(b - a)
        seg_len = np.linalg.norm(b - a) - (2 * corner_r if turn else corner_r)
        n_seg = max(int(seg_len / step), 1)
        for k in range(n_seg):
            if len(pts) >= n_poses:
                break
            p = a + d1 * (corner_r + k * step)
            pts.append([p[0], p[1], z])
            yaws.append(np.arctan2(d1[1], d1[0]))
        if turn:
            c = corners[(i + 2) % n_wp]
            d2 = (c - b) / np.linalg.norm(c - b)
            # the signed turn: +90° left, -90° right, as the cross product says
            side = 1.0 if d1[0] * d2[1] - d1[1] * d2[0] > 0 else -1.0
            center = b - d1 * corner_r + d2 * corner_r
            yaw0 = np.arctan2(d1[1], d1[0])
            arc_len = np.pi / 2 * corner_r
            n_arc = max(int(arc_len / step), 1)
            for k in range(n_arc):
                if len(pts) >= n_poses:
                    break
                th = side * (k + 0.5) / n_arc * (np.pi / 2)
                start = b - d1 * corner_r
                rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
                p = center + rot @ (start - center)
                pts.append([p[0], p[1], z])
                yaws.append(yaw0 + th)
        i += 1
    pos = np.asarray(pts, np.float64)
    yaw = np.asarray(yaws, np.float64)
    return pos.astype(np.float32), _yaw_quats(yaw).astype(np.float32)


def seeds(seed: int) -> Tuple[int, int, int]:
    """(world, scans, moving objects) ``RandomState`` seeds from a seed,
    any non-negative integer (the driver's exceed 32 bits)."""
    w, s, o = np.random.SeedSequence(int(seed)).generate_state(3, dtype=np.uint32)
    return int(w), int(s), int(o)


def lap_poses(waypoints: Sequence[Sequence[int]], block_size: float = 80.0,
              street_width: float = 18.0, speed: float = 8.0, rate_hz: float = 10.0,
              **_world) -> int:
    """Poses in one lap of a closed route (``route_drive``'s counts)."""
    half = street_width / 2.0
    pitch = block_size + street_width
    corner_r = min(6.0, half * 0.9 + 2.0)
    step = speed / rate_hz
    c = np.array([[half + i * pitch, half + j * pitch] for i, j in waypoints], np.float64)
    legs = np.linalg.norm(np.roll(c, -1, axis=0) - c, axis=1)
    n_arc = max(int(np.pi / 2 * corner_r / step), 1)
    return int(sum(max(int((L - 2 * corner_r) / step), 1) + n_arc for L in legs))


def order(traffic: dict, sensor: dict, seed: int) -> Tuple[int, int]:
    """(offset, first noise seed) of a run's sequence. A closed route's
    sequence is a whole number of laps of fixed scans (their noise drawn
    from the scene seed), started at an offset that the run's seed picks,
    so every seed drives the same scans in another order; an open route's
    scans draw their noise from the run's seed."""
    n = int(traffic["scans"])
    r = traffic["route"]
    if not r["closed"]:
        return 0, seeds(seed)[1]
    lap = lap_poses(r["waypoints"], speed=float(traffic["speed"]),
                    rate_hz=float(sensor["rate_hz"]), **traffic["world"])
    if n % lap:
        raise ValueError(f"a closed route's scans ({n}) must be whole laps of {lap}")
    return seeds(seed)[1] % n, seeds(int(traffic["scene_seed"]))[1]


def trajectory(traffic: dict, sensor: dict, seed: int = 0) -> Trajectory:
    """The ground-truth drive of a run's sequence (see :func:`order`)."""
    r = traffic["route"]
    n = int(traffic["scans"])
    k, _ = order(traffic, sensor, seed)
    t, q = route_drive(r["waypoints"], bool(r["closed"]), n + k,
                       speed=float(traffic["speed"]), rate_hz=float(sensor["rate_hz"]),
                       z=float(traffic["z"]), **traffic["world"])
    return t[k:], q[k:]


def _render_kw(sensor: dict) -> dict:
    keys = ("n_beams", "azimuth_bins", "max_range", "min_range", "noise")
    kw = {k: sensor[k] for k in keys}
    kw["elevation_range"] = tuple(sensor["elevation_range"])
    physics = sensor.get("physics")
    if physics:
        kw.update(noise_range_coeff=float(physics["noise_range_coeff"]),
                  dropout=float(physics["dropout"]))
    return kw


def _render_range(job) -> List[np.ndarray]:
    """Worker: the valid points of scans ``[lo, hi)`` of the sequence."""
    traffic, sensor, seed, lo, hi, capacity = job
    # the scene (world layout, moving objects) is the traffic's
    world_seed, _, objects_seed = seeds(int(traffic["scene_seed"]))
    k, scan_seed = order(traffic, sensor, seed)
    world = make_urban_world(seed=world_seed, **traffic["world"])
    t, q = trajectory(traffic, sensor, seed)
    t64, q64 = t.astype(np.float64), q.astype(np.float64)
    physics = sensor.get("physics")
    rate = float(sensor["rate_hz"])
    dynamic = None
    if physics and int(physics["vehicles"]) > 0:
        w = traffic["world"]
        dynamic = make_moving_objects(seed=objects_seed, n_vehicles=int(physics["vehicles"]),
                                      blocks=w["blocks"], block_size=w["block_size"],
                                      street_width=w["street_width"])
    kw = _render_kw(sensor)
    n = t.shape[0]
    out = []
    for i in range(lo, hi):
        world_i = world if dynamic is None else np.concatenate([world, dynamic(i / rate)])
        extra = {}
        if physics and physics["distortion"] and i + 1 < n:
            extra = dict(next_pose_t=t64[i + 1], next_pose_q=q64[i + 1])
        out.append(render_velodyne_scan(world_i, t64[i], q64[i],
                                        seed=(scan_seed + (k + i) % n) % 2**32,
                                        max_points=capacity, **kw, **extra))
    return out


class Render:
    """The scans of a sequence, rendered in spawned worker processes
    (:func:`render_sequence`)."""

    def __init__(self, jobs, workers: int):
        self._scans = None
        self._pool = None
        if workers <= 0:
            self._scans = [s for job in jobs for s in _render_range(job)]
            return
        self._pool = multiprocessing.get_context("spawn").Pool(processes=min(workers, len(jobs)))
        self._pending = self._pool.map_async(_render_range, jobs)

    def result(self) -> List[np.ndarray]:
        """Wait for the scans, (n_i, 3) float32 arrays, and stop the
        workers."""
        if self._scans is None:
            try:
                self._scans = [s for part in self._pending.get() for s in part]
            finally:
                self.stop()
        return self._scans

    def stop(self) -> None:
        """End the workers, done or not, and wait for them and for the
        resource tracker the pool started."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = self._pending = None
            gc.collect()  # the pool's semaphores, unregistered before the tracker stops
            stop = getattr(resource_tracker._resource_tracker, "_stop", None)
            if stop is not None:
                stop()


def render_sequence(traffic: dict, sensor: dict, seed: int, capacity: int,
                    workers: int = 7, count: Optional[int] = None) -> Render:
    """Start rendering the first ``count`` scans (default: all) of the
    traffic's sequence from ``seed``, in ``workers`` processes (0: here,
    before returning)."""
    n = int(traffic["scans"]) if count is None else count
    per = max(1, -(-n // max(workers, 1)))
    jobs = [(traffic, sensor, int(seed), lo, min(lo + per, n), capacity)
            for lo in range(0, n, per)]
    return Render(jobs, workers)
