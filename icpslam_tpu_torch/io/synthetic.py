"""Synthetic worlds and scan streams with ground truth, numpy only (port of
the producers of ``icpslam_tpu/io/synthetic.py`` that the runner uses).

Same seeds, same arrays as the JAX package: the room loop
(``make_room_world``, ``make_loop_trajectory``, ``render_scan``,
``scan_stream``) and the KITTI-scale urban proxy (``make_urban_world``,
``make_urban_drive``, ``render_velodyne_scan``, ``velodyne_stream``),
idealized by default or with the sensor physics of the JAX render:
motion distortion across the sweep, range-dependent noise, dropout and
moving traffic (``make_moving_objects``), and the INS de-skew at ingest
(``ins_relative_motion``, ``deskew_scan``). Every ``RandomState`` is drawn
in the JAX version's order, so a seed gives the JAX version's points.
Trajectories are ``(t (T, 3), q (T, 4))`` float32 arrays; streams yield
padded ``(points (C, 3) float32, mask (C,) bool)`` numpy pairs, and the
caller moves them to its device.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

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


def make_room_world(
    seed: int = 0,
    n_points: int = 20000,
    size: float = 20.0,
    height: float = 3.0,
    pillar_frac: float = 0.15,
) -> np.ndarray:
    """Dense points on a box room's floor and walls plus a dozen pillars."""
    rng = np.random.RandomState(seed)
    half = size / 2.0
    n_pillar = max(int(n_points * pillar_frac), 200)
    n_rest = n_points - n_pillar
    n_wall = (n_rest - n_rest // 3) // 4
    n_floor = n_rest - 4 * n_wall
    parts = [
        np.c_[rng.uniform(-half, half, (n_floor, 2)), np.zeros(n_floor)],
        np.c_[rng.uniform(-half, half, n_wall), np.full(n_wall, half), rng.uniform(0, height, n_wall)],
        np.c_[rng.uniform(-half, half, n_wall), np.full(n_wall, -half), rng.uniform(0, height, n_wall)],
        np.c_[np.full(n_wall, half), rng.uniform(-half, half, n_wall), rng.uniform(0, height, n_wall)],
        np.c_[np.full(n_wall, -half), rng.uniform(-half, half, n_wall), rng.uniform(0, height, n_wall)],
    ]
    n_pil = 12
    centers = rng.uniform(-half * 0.85, half * 0.85, (n_pil, 2))
    radii = rng.uniform(0.2, 0.6, n_pil)
    th = rng.uniform(0, 2 * np.pi, n_pillar)
    which = rng.randint(0, n_pil, n_pillar)
    parts.append(np.c_[
        centers[which, 0] + radii[which] * np.cos(th),
        centers[which, 1] + radii[which] * np.sin(th),
        rng.uniform(0, height, n_pillar),
    ])
    return np.concatenate(parts).astype(np.float32)


def _yaw_quats(yaw: np.ndarray) -> np.ndarray:
    return np.stack(
        [np.cos(yaw / 2), np.zeros_like(yaw), np.zeros_like(yaw), np.sin(yaw / 2)],
        axis=-1,
    )


def make_loop_trajectory(
    n_poses: int = 60, radius: float = 6.0, z: float = 1.0, laps: float = 1.0
) -> Trajectory:
    """Circular loop, heading tangent to the circle."""
    theta = np.linspace(0, 2 * np.pi * laps, n_poses, endpoint=False)
    t = np.c_[radius * np.cos(theta), radius * np.sin(theta), np.full(n_poses, z)]
    q = _yaw_quats(theta + np.pi / 2)
    return t.astype(np.float32), q.astype(np.float32)


def _rotate_f32(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """``quaternion.rotate`` in float32, term for term."""
    u = q[..., 1:]
    w = q[..., :1]
    uv = np.cross(u, v).astype(np.float32)
    return v + np.float32(2.0) * (w * uv + np.cross(u, uv).astype(np.float32))


def render_scan(
    world: np.ndarray,
    pose_t: np.ndarray,
    pose_q: np.ndarray,
    max_range: float = 10.0,
    n_points: int = 2048,
    noise: float = 0.01,
    seed: int = 0,
) -> np.ndarray:
    """World points within range, in the sensor frame, subsampled to
    ``n_points`` with Gaussian noise — float32 like the JAX version's
    ``se3.inverse`` + ``transform_points``."""
    rng = np.random.RandomState(seed)
    d = np.linalg.norm(world - pose_t[None, :], axis=-1)
    visible = world[d <= max_range]
    if visible.shape[0] > n_points:
        sel = rng.choice(visible.shape[0], n_points, replace=False)
        visible = visible[sel]
    t = np.asarray(pose_t, np.float32)
    q = np.asarray(pose_q, np.float32)
    qi = np.concatenate([q[:1], -q[1:]]).astype(np.float32)
    ti = -_rotate_f32(qi, t)
    local = _rotate_f32(qi[None, :], visible.astype(np.float32)) + ti[None, :]
    if noise:
        local = local + rng.randn(*local.shape).astype(np.float32) * noise
    return local.astype(np.float32)


def scan_stream(
    world: np.ndarray,
    trajectory: Trajectory,
    capacity: int,
    max_range: float = 10.0,
    n_points: int = 2048,
    noise: float = 0.01,
    seed: int = 0,
    rate_hz: float = 0.0,
) -> Iterator:
    """Padded sensor-frame scans along a trajectory; with ``rate_hz > 0``
    yields ``((points, mask), stamp)``."""
    t, q = trajectory
    for i in range(t.shape[0]):
        pts = render_scan(
            world, t[i], q[i], max_range=max_range, n_points=n_points,
            noise=noise, seed=seed + i,
        )
        cloud = pad(pts, capacity)
        yield (cloud, i / rate_hz) if rate_hz > 0 else cloud


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


def _quat_mul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


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


def deskew_scan(
    points: np.ndarray,
    rel_t: np.ndarray,
    rel_q: np.ndarray,
    times: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Undo the intra-sweep motion ``rel`` (start → end) under constant
    velocity: ``p' = T(u)·p`` in the sweep-start frame, with ``u`` the
    per-point sweep fraction (from the azimuth when ``times`` is None)."""
    if times is None:
        az = np.arctan2(points[:, 1], points[:, 0])
        times = ((az + np.pi) / (2 * np.pi)).astype(np.float64)
    u = np.asarray(times, np.float64)
    t1 = np.asarray(rel_t, np.float64)
    q0 = np.array([1.0, 0.0, 0.0, 0.0])
    q_u = _quat_slerp_np(q0, np.asarray(rel_q, np.float64), u)
    t_u = t1[None, :] * u[:, None]
    return (_quat_rot_np(q_u, points.astype(np.float64)) + t_u).astype(np.float32)


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


def ins_relative_motion(
    t: np.ndarray, q: np.ndarray, i: int, rng, noise_t: float, noise_r: float
) -> Tuple[np.ndarray, np.ndarray]:
    """A noisy INS measurement of the sensor motion over sweep ``i`` (body_i
    → body_{i+1}): σ = ``noise_t`` m on the translation, a rotation
    perturbation of σ = ``noise_r`` rad per axis."""
    j = min(i + 1, t.shape[0] - 1)
    q_conj = np.array([q[i][0], -q[i][1], -q[i][2], -q[i][3]])
    q_conj = q_conj / np.linalg.norm(q_conj)
    rel_q = _quat_mul_np(q_conj, q[j] / np.linalg.norm(q[j]))
    rel_t = _quat_rot_np(q_conj[None, :], (t[j] - t[i])[None, :])[0]
    if noise_t:
        rel_t = rel_t + rng.randn(3) * noise_t
    if noise_r:
        dq = np.concatenate([[1.0], rng.randn(3) * noise_r])
        rel_q = _quat_mul_np(rel_q, dq / np.linalg.norm(dq))
    return rel_t, rel_q / np.linalg.norm(rel_q)


def velodyne_stream(
    world: np.ndarray,
    trajectory: Trajectory,
    capacity: int,
    rate_hz: float = 10.0,
    seed: int = 0,
    dynamic=None,
    distortion: bool = False,
    deskew: bool = False,
    ins_noise_t: float = 0.01,
    ins_noise_r: float = 0.002,
    **render_kw,
) -> Iterator:
    """64-beam scans with 10 Hz stamps: ``((points, mask), stamp)``.

    ``dynamic``: a ``t -> (n, 3)`` callable of moving points added to the
    world per scan (``make_moving_objects``); ``distortion`` smears each
    sweep across the motion to the next pose; ``deskew`` then undoes it at
    ingest with a noisy INS measurement (``ins_relative_motion``, its own
    ``RandomState(seed + 90001)``). ``render_kw`` goes to
    ``render_velodyne_scan``. The defaults are the idealized render."""
    if deskew and distortion:
        raw = velodyne_stream(world, trajectory, capacity, rate_hz, seed, dynamic,
                              distortion=True, **render_kw)
        yield from ins_deskew_stream(raw, trajectory, seed, ins_noise_t, ins_noise_r)
        return
    t = np.asarray(trajectory[0], np.float64)
    q = np.asarray(trajectory[1], np.float64)
    n = t.shape[0]
    for i in range(n):
        world_i = world if dynamic is None else np.concatenate([world, dynamic(i / rate_hz)])
        kw = dict(render_kw)
        if distortion and i + 1 < n:
            kw.update(next_pose_t=t[i + 1], next_pose_q=q[i + 1])
        pts = render_velodyne_scan(world_i, t[i], q[i], seed=seed + i, max_points=capacity, **kw)
        yield pad(pts, capacity), i / rate_hz


def ins_deskew_stream(
    scans, trajectory: Trajectory, seed: int = 0,
    ins_noise_t: float = 0.01, ins_noise_r: float = 0.002,
) -> Iterator:
    """The INS de-skew of ``velodyne_stream(deskew=True)``, applied to scans
    rendered with ``distortion=True`` (same ``trajectory`` and ``seed``),
    so one render serves both the raw and the de-skewed drive. The last
    scan has no next pose and passes unchanged."""
    t = np.asarray(trajectory[0], np.float64)
    q = np.asarray(trajectory[1], np.float64)
    n = t.shape[0]
    ins_rng = np.random.RandomState(seed + 90001)
    for i, ((points, mask), stamp) in enumerate(scans):
        if i + 1 < n:
            rel_t, rel_q = ins_relative_motion(t, q, i, ins_rng, ins_noise_t, ins_noise_r)
            points, mask = pad(deskew_scan(points[mask], rel_t, rel_q), mask.shape[0])
        yield (points, mask), stamp
