"""Offline exports, the rviz-profile replacement (port of
``icpslam_tpu/viz/export.py``).

Files any viewer reads, byte for byte as the JAX package writes them for
the same inputs:

- ``save_ply``: a cloud or the map as binary little-endian PLY;
- ``export_trajectory_tum``: a trajectory in TUM format (``evo`` reads it);
- ``export_pose_graph_json``: the keyframe graph's nodes (id, stamp, pose,
  covariance diagonal, colour-ramp position) and edges, typed 'loop' or
  'sequential' by the reference's |i − j| > 2 rule.

Inputs are the port's tensors (any device) or numpy arrays.
"""

from __future__ import annotations

import json
import struct
from typing import Optional

import numpy as np

from icpslam_tpu_torch.geometry.se3 import Pose


def host(x) -> np.ndarray:
    """A tensor or array as a host numpy array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def cloud_points(cloud) -> np.ndarray:
    """The valid points of a ``PointCloud`` (or ``(points, mask)``), (n, 3)."""
    points, mask = cloud
    return host(points)[host(mask)]


def save_ply(path: str, cloud, colors: Optional[np.ndarray] = None) -> int:
    """Write the valid points of a cloud as binary little-endian PLY, with
    optional uchar RGB ``colors``. Returns the number of points written."""
    pts = cloud_points(cloud).astype("<f4")
    n = pts.shape[0]
    has_color = colors is not None
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
                  "property float x", "property float y", "property float z"]
        if has_color:
            header += ["property uchar red", "property uchar green", "property uchar blue"]
        header.append("end_header")
        f.write(("\n".join(header) + "\n").encode())
        if has_color:
            cols = np.asarray(colors, np.uint8)[:n]
            for i in range(n):
                f.write(struct.pack("<fff", *pts[i]) + struct.pack("BBB", *cols[i]))
        else:
            f.write(pts.tobytes())
    return n


def export_trajectory_tum(path: str, poses: Pose, stamps=None) -> int:
    """TUM format, ``stamp tx ty tz qx qy qz qw`` per line (the scan index
    without ``stamps``). Returns the number of poses."""
    t = host(poses.t)
    q = host(poses.q)  # wxyz
    n = t.shape[0]
    stamps = np.arange(n, dtype=np.float64) if stamps is None else np.asarray(stamps)
    with open(path, "w") as f:
        for i in range(n):
            f.write(
                f"{stamps[i]:.6f} {t[i,0]:.6f} {t[i,1]:.6f} {t[i,2]:.6f} "
                f"{q[i,1]:.6f} {q[i,2]:.6f} {q[i,3]:.6f} {q[i,0]:.6f}\n"
            )
    return n


def export_pose_graph_json(path: str, state, config=None) -> dict:
    """The keyframe graph as JSON: nodes and valid edges. Returns the
    document written."""
    store = state.keyframes
    n = int(store.count)
    t = host(store.pose_graph.t)[:n]
    q = host(store.pose_graph.q)[:n]
    stamps = host(store.stamp)[:n]
    cov_diag = np.einsum("kii->ki", host(store.cov)[:n])  # all-zero rows: not recorded
    nodes = [
        {
            "id": i,
            "stamp": float(stamps[i]),
            "t": [float(x) for x in t[i]],
            "q_wxyz": [float(x) for x in q[i]],
            "cov_diag": [float(x) for x in cov_diag[i]],
            "ramp": i / max(n - 1, 1),
        }
        for i in range(n)
    ]
    ecount = int(state.edges.count)
    ei = host(state.edges.i)[:ecount]
    ej = host(state.edges.j)[:ecount]
    valid = host(state.edges.valid)[:ecount]
    edges = [
        {"i": int(ei[k]), "j": int(ej[k]),
         "type": "loop" if abs(int(ej[k]) - int(ei[k])) > 2 else "sequential"}
        for k in range(ecount) if valid[k]
    ]
    doc = {
        "nodes": nodes,
        "edges": edges,
        "num_loop_closures": int(state.num_loop_closures),
        "num_optimizations": int(state.num_optimizations),
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return doc
