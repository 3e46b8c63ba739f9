"""KITTI odometry dataset reading and writing (port of ``icpslam_tpu/io/kitti.py``).

The layout the reader expects and ``write_tree`` writes:

    <root>/sequences/<seq>/velodyne/000000.bin   float32 x,y,z,reflectance
    <root>/sequences/<seq>/calib.txt             P0..P3, Tr (velo→cam0)
    <root>/sequences/<seq>/times.txt             one stamp per scan
    <root>/poses/<seq>.txt                       3x4 cam0 ground-truth poses

Host code, numpy only. Scans are in the velodyne frame; streams yield
padded ``(points (C, 3) float32, mask (C,) bool)`` pairs, or
``((points, mask), stamp)`` with ``with_stamps``, as the port's synthetic
sources do. Trajectories are ``(t (T, 3), q (T, 4) wxyz)`` float32 arrays;
the ground truth is converted to the velodyne frame through ``Tr`` in
float64 and only then rounded to float32, as the JAX reader does.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from icpslam_tpu_torch.io.synthetic import Trajectory, pad


def read_scan(path: str, max_points: Optional[int] = None, min_range: float = 2.5,
              max_range: float = 80.0, seed: int = 0) -> np.ndarray:
    """One velodyne ``.bin`` scan as (n, 3) float32 in the sensor frame.

    Points closer than ``min_range`` (ego returns) or beyond ``max_range``
    are dropped; above ``max_points`` a random subsample drawn with
    ``RandomState(seed)`` is kept (the native reader takes an even stride
    instead, ``io/native_loader.py``).
    """
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)[:, :3]
    r = np.linalg.norm(raw, axis=-1)
    raw = raw[(r >= min_range) & (r <= max_range)]
    if max_points is not None and raw.shape[0] > max_points:
        sel = np.random.RandomState(seed).choice(raw.shape[0], max_points, replace=False)
        raw = raw[sel]
    return raw.astype(np.float32)


def read_calib(seq_dir: str) -> np.ndarray:
    """4x4 float64 ``Tr`` (cam0 ← velodyne) from calib.txt."""
    path = os.path.join(seq_dir, "calib.txt")
    with open(path) as f:
        for line in f:
            if line.startswith("Tr"):
                vals = np.array([float(x) for x in line.split()[1:]], np.float64)
                tr = np.eye(4)
                tr[:3, :4] = vals.reshape(3, 4)
                return tr
    raise ValueError(f"no Tr entry in {path}")


def read_poses(root: str, seq: str) -> np.ndarray:
    """(N, 4, 4) float64 cam0-frame ground-truth poses from poses/<seq>.txt."""
    path = os.path.join(root, "poses", f"{seq}.txt")
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (rows.shape[0], 1, 1))
    out[:, :3, :4] = rows
    return out


def _normalize(q: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(q, axis=-1, keepdims=True)
    ok = n > 1e-12
    out = q / np.where(ok, n, np.ones_like(n))
    ident = np.zeros_like(q)
    ident[..., 0] = 1.0
    return np.where(ok, out, ident)


def quat_from_matrix(m: np.ndarray) -> np.ndarray:
    """Unit quaternions (..., 4) wxyz from rotation matrices (..., 3, 3),
    in the matrices' dtype: Shepperd's method with ``w >= 0``, as
    ``icpslam_tpu/geometry/quaternion.py::from_matrix``."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    one = m.dtype.type(1.0)
    zero = m.dtype.type(0.0)
    tr = m00 + m11 + m22
    qw2 = np.maximum(one + tr, zero)
    qx2 = np.maximum(one + m00 - m11 - m22, zero)
    qy2 = np.maximum(one - m00 + m11 - m22, zero)
    qz2 = np.maximum(one - m00 - m11 + m22, zero)
    cands = np.stack([
        np.stack([qw2, m21 - m12, m02 - m20, m10 - m01], axis=-1),
        np.stack([m21 - m12, qx2, m01 + m10, m02 + m20], axis=-1),
        np.stack([m02 - m20, m01 + m10, qy2, m12 + m21], axis=-1),
        np.stack([m10 - m01, m02 + m20, m12 + m21, qz2], axis=-1),
    ], axis=-2)
    best = np.argmax(np.stack([qw2, qx2, qy2, qz2], axis=-1), axis=-1)
    q = np.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    q = _normalize(q)
    return np.where(q[..., :1] < 0, -q, q)


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """Rotation matrices (..., 3, 3) from unit quaternions (..., 4) wxyz,
    in the quaternions' dtype."""
    w, x, y, z = (q[..., i] for i in range(4))
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    one, two = q.dtype.type(1.0), q.dtype.type(2.0)
    m = np.stack([
        one - two * (yy + zz), two * (xy - wz), two * (xz + wy),
        two * (xy + wz), one - two * (xx + zz), two * (yz - wx),
        two * (xz - wy), two * (yz + wx), one - two * (xx + yy),
    ], axis=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def ground_truth_velodyne(root: str, seq: str) -> Trajectory:
    """The ground truth in the velodyne frame,
    ``T_w_velo[k] = Tr⁻¹ · T_w_cam[k] · Tr`` (world fixed to velodyne frame
    0), computed in float64 and then rounded to float32: ``(t, q)``."""
    seq_dir = os.path.join(root, "sequences", seq)
    tr = read_calib(seq_dir)
    cam = read_poses(root, seq)
    velo = np.einsum("ij,njk,kl->nil", np.linalg.inv(tr), cam, tr).astype(np.float32)
    return np.ascontiguousarray(velo[:, :3, 3]), quat_from_matrix(velo[:, :3, :3])


def read_times(root: str, seq: str) -> np.ndarray:
    """(N,) float64 sensor stamps from sequences/<seq>/times.txt."""
    path = os.path.join(root, "sequences", seq, "times.txt")
    return np.loadtxt(path, dtype=np.float64).reshape(-1)


def _pad_stamps(stamps: np.ndarray, n: int) -> np.ndarray:
    """Extend a short stamp array to ``n`` entries at a 10 Hz continuation,
    so a truncated times.txt does not end a long run mid-stream."""
    if stamps.shape[0] >= n:
        return stamps
    last = float(stamps[-1]) if stamps.shape[0] else 0.0
    extra = last + 0.1 * np.arange(1, n - stamps.shape[0] + 1)
    return np.concatenate([stamps, extra])


def scan_files(root: str, seq: str) -> List[str]:
    d = os.path.join(root, "sequences", seq, "velodyne")
    return sorted(os.path.join(d, f) for f in os.listdir(d) if f.endswith(".bin"))


def stamps_for(root: str, seq: str, start: int, n: int, end: Optional[int] = None) -> np.ndarray:
    """The stamps of scans ``[start, start + n)``: times.txt's, or a 10 Hz
    counter when it is missing, padded to ``n``."""
    try:
        stamps = read_times(root, seq)[start:end]
    except (FileNotFoundError, OSError):
        stamps = np.arange(start, start + n, dtype=np.float64) * 0.1
    return _pad_stamps(stamps, n)


def scan_stream(
    root: str,
    seq: str,
    capacity: int,
    max_points: Optional[int] = None,
    start: int = 0,
    end: Optional[int] = None,
    with_stamps: bool = False,
):
    """Yield padded ``(points, mask)`` scans read by ``read_scan`` (the
    subsample seed is the scan's index in the range); with ``with_stamps``,
    ``((points, mask), stamp)`` pairs from times.txt (a 10 Hz counter
    when it is missing)."""
    files = scan_files(root, seq)[start:end]
    stamps = stamps_for(root, seq, start, len(files), end) if with_stamps else None
    for i, f in enumerate(files):
        scan = pad(read_scan(f, max_points=max_points or capacity, seed=i), capacity)
        yield (scan, float(stamps[i])) if with_stamps else scan


# a non-trivial velodyne→cam0 calibration: the axis permutation (cam: x
# right, y down, z forward; velodyne: x forward, y left, z up) and a
# centimetre-scale lever arm, of real KITTI Tr magnitudes
DEFAULT_TR = np.array([
    [0.0, -1.0, 0.0, -0.0027],
    [0.0, 0.0, -1.0, -0.0648],
    [1.0, 0.0, 0.0, -0.2085],
    [0.0, 0.0, 0.0, 1.0],
], np.float64)


def write_tree(
    root: str,
    seq: str,
    scans,
    gt_velo: Trajectory,
    stamps: Optional[np.ndarray] = None,
    tr: Optional[np.ndarray] = None,
    reflectance_seed: int = 0,
) -> str:
    """Write a KITTI odometry tree (4-column ``.bin`` scans, ``Tr`` in
    calib.txt, times.txt, cam0-frame poses) that the reader and the
    runner's ``--kitti`` drive, byte for byte as the JAX ``write_tree``
    writes it for the same inputs.

    ``scans``: iterable of (n, 3) float32 sensor-frame clouds.
    ``gt_velo``: the velodyne-frame trajectory ``(t, q)``; written to
    poses/ as ``T_w_cam = Tr · T_w_velo · Tr⁻¹``, the inverse of
    ``ground_truth_velodyne``. Without ``stamps``, 10 Hz stamps with
    ±4 ms jitter from 0. Returns ``root``.
    """
    tr = DEFAULT_TR if tr is None else np.asarray(tr, np.float64)
    seq_dir = os.path.join(root, "sequences", seq)
    velo_dir = os.path.join(seq_dir, "velodyne")
    os.makedirs(velo_dir, exist_ok=True)
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)

    rng = np.random.RandomState(reflectance_seed)
    n_scans = 0
    for i, pts in enumerate(scans):
        pts = np.asarray(pts, np.float32).reshape(-1, 3)
        refl = rng.uniform(0.0, 1.0, (pts.shape[0], 1)).astype(np.float32)
        np.c_[pts, refl].astype(np.float32).tofile(os.path.join(velo_dir, f"{i:06d}.bin"))
        n_scans += 1

    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        p = np.zeros((3, 4))
        p[:3, :3] = np.eye(3) * 718.856  # plausible intrinsics, unused here
        row = " ".join(f"{v:.12e}" for v in p.reshape(-1))
        for k in range(4):
            f.write(f"P{k}: {row}\n")
        f.write("Tr: " + " ".join(f"{v:.12e}" for v in tr[:3].reshape(-1)) + "\n")

    if stamps is None:
        stamps = np.cumsum(0.1 + rng.uniform(-0.004, 0.004, n_scans))
        stamps -= stamps[0]
    np.savetxt(os.path.join(seq_dir, "times.txt"), np.asarray(stamps), fmt="%.6e")

    t = np.asarray(gt_velo[0], np.float64)[:n_scans]
    q = np.asarray(gt_velo[1], np.float32)[:n_scans]
    mats = np.tile(np.eye(4), (n_scans, 1, 1))
    mats[:, :3, :3] = quat_to_matrix(q).astype(np.float64)
    mats[:, :3, 3] = t
    cam = np.einsum("ij,njk,kl->nil", tr, mats, np.linalg.inv(tr))
    np.savetxt(os.path.join(root, "poses", f"{seq}.txt"),
               cam[:, :3, :].reshape(n_scans, 12), fmt="%.9e")
    return root


def find_dataset(candidates=("/data/kitti", "./data/kitti")) -> Optional[str]:
    """A mounted KITTI odometry root among ``candidates``, or None."""
    for c in candidates:
        if os.path.isdir(os.path.join(c, "sequences")):
            return c
    return None
