"""Typed configuration for the SLAM pipeline — the port's own copy.

The same ``IcpConfig`` / ``SlamConfig`` fields and defaults as the JAX
package's ``icpslam_tpu/config.py``, with ``kitti_config``, ``tiny_config``,
``from_dict``, ``from_yaml`` and ``save_yaml``. The port keeps a copy
instead of loading that module, so it imports nothing of the JAX package;
``tests/test_torch_package.py`` holds the copy to the JAX module field for
field and default for default. ``yaml`` is imported only by the YAML
functions: nothing else on the port's path needs PyYAML.

Options the port does not cover yet are still fields here (a config is
shared with JAX users); ``pipeline/slam.py::check_supported`` raises on
them, naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class IcpConfig:
    """Registration knobs shared by scan-to-scan and scan-to-map ICP."""

    max_iterations: int = 10
    max_correspondence_distance: float = 1.0
    # early exit on the se(3) twist norm of the per-iteration update
    transformation_epsilon: float = 1e-4
    fitness_threshold: float = 20.0   # accept gate on the mean squared residual
    # GICP covariances: 'knn' (k nearest neighbours, kernel K2 in the port)
    # or 'radius' (fixed-radius moments, kernel K3). With
    # covariance_sigma > 0 the radius weights taper as exp(−d²/2σ²).
    covariance_mode: str = "knn"
    covariance_radius: float = 0.5   # meters (~2.5 voxel leaves)
    covariance_sigma: float = 0.0    # Gaussian taper σ for radius mode (0 = hard cutoff)
    covariance_knn: int = 10
    covariance_epsilon: float = 1e-3
    # 'point' (Kabsch point-to-point) or 'plane' (GICP-style plane-to-plane GN)
    mode: str = "plane"
    # re-run the NN search every n-th ICP iteration (1 = every iteration)
    correspondence_refresh: int = 1
    # True: fitness from an extra correspondence pass at the final pose;
    # False: reuse the last iteration's correspondences
    exact_fitness: bool = False
    # Huber robust-loss scale in meters (0 disables robust weighting)
    huber_delta: float = 0.5


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    # --- frames; informational, used by IO adapters ---
    map_frame: str = "map"
    odom_frame: str = "odom"
    robot_frame: str = "base_link"
    laser_frame: str = "laser"

    # --- pose of the laser in the robot frame (t xyz, q wxyz), applied to
    # every raw scan at ingest ---
    laser_extrinsic_t: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    laser_extrinsic_q: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)

    # --- front-end odometry ---
    num_clouds_skip: int = 0
    voxel_leaf_size: float = 0.2
    icp_odometry: IcpConfig = dataclasses.field(default_factory=IcpConfig)
    # in-loop motion de-skew: > 0 enables it (not ported yet)
    deskew_rounds: int = 0
    deskew_mode: str = "coupled"      # 'coupled', 'joint' or 'alternate'
    deskew_prior_weight: float = 100.0
    deskew_prior_huber: float = 0.0
    deskew_free_twist: bool = False
    deskew_auto_prior: bool = False
    deskew_auto_turn_threshold: float = 0.02
    deskew_auto_straight_weight: float = 2000.0

    # --- mapping ---
    map_resolution: float = 0.2
    icp_mapping: IcpConfig = dataclasses.field(
        default_factory=lambda: IcpConfig(max_iterations=30)
    )
    # map-NN search radius in voxels (voxel backend)
    map_nn_radius: int = 1
    # scan-to-map reuses the map-NN pairing for all its ICP iterations
    mapping_fixed_correspondences: bool = True
    # with fixed correspondences: total map-query + register rounds allowed
    # when the correction is large (> map_resolution/10 mean displacement)
    mapping_requery_rounds: int = 3
    # 'point' (append-only map, exact NN), 'voxel' or 'sharded'
    map_backend: str = "point"
    map_shards: int = 1
    # a full point map: 'none' drops new points (counted in overflow),
    # 'ring' overwrites the oldest
    map_eviction: str = "none"
    enable_scan_to_map: bool = True

    # --- keyframes & graph ---
    keyframe_distance: float = 0.3
    keyframes_window: int = 4         # optimize every this many keyframes
    icp_information: Tuple[float, ...] = (100.0, 100.0, 100.0, 100.0, 100.0, 100.0)
    # sequential-edge information from the registration's GN Hessian,
    # rescaled to icp_information's mean diagonal (False: fixed diagonals)
    adaptive_information: bool = False
    odometry_information: Tuple[float, ...] = (10.0, 10.0, 10.0, 10.0, 10.0, 10.0)
    loop_information: Tuple[float, ...] = (100.0, 100.0, 100.0, 100.0, 100.0, 100.0)
    enable_loop_closure: bool = True
    loop_closure_radius: float = 3.0
    loop_closure_min_id_gap: int = 3
    # top-k radius candidates proposed per new keyframe
    loop_closure_candidates: int = 2
    # verification registration mode: 'point' (Kabsch) or 'plane' (GICP)
    loop_closure_icp_mode: str = "point"
    # fraction of source points that must find a correspondence (0 disables)
    loop_closure_min_inlier_ratio: float = 0.3
    loop_closure_vectorized: bool = True
    graph_solver: str = "lm"          # 'gn' or 'lm'
    graph_solver_iterations: int = 3
    # 'direct', 'pcg', 'schur', 'auto' (direct up to 256 nodes, PCG above)
    # or 'dist-*' (edge-sharded over a device mesh)
    graph_linear_solver: str = "auto"
    # incremental back-end: between loop closures solve only the last
    # graph_window nodes, conditioned exactly on the frozen prefix (edges
    # into the prefix become unary priors); a loop closure since the last
    # solve triggers a full-graph solve
    graph_incremental: bool = True
    graph_window: int = 64
    # solve at power-of-two keyframe prefixes (>= graph_bucket_min)
    graph_bucketing: bool = True
    graph_bucket_min: int = 64
    # pipelined back-end: the solve runs asynchronously (not ported yet)
    defer_optimization: bool = False

    # --- wheel / external odometry fusion ---
    wheel_odom_pose_gate: float = 0.1
    enable_wheel_odom_edges: bool = False

    # a full keyframe store: 'marginalize' evicts the most redundant frozen
    # keyframe (graph/marginalize.py); 'none' stops adding keyframes
    keyframe_eviction: str = "marginalize"
    keyframe_protect_recent: int = 8
    keyframe_loop_edge_penalty: float = 10.0

    # --- static capacities ---
    max_points: int = 8192            # downsampled points per scan
    max_raw_points: int = 131072      # raw scan capacity before voxel filter
    max_map_points: int = 262144      # map capacity
    max_keyframes: int = 512
    max_edges: int = 2048

    # --- visualization markers ---
    marker_scale_nodes: float = 0.1
    marker_scale_edges: float = 0.05
    icp_nodes_markers_color: Tuple[float, ...] = (0.0, 1.0, 0.0, 1.0)
    odom_nodes_markers_color: Tuple[float, ...] = (0.0, 0.5, 0.5, 1.0)
    edges_markers_color: Tuple[float, ...] = (0.0, 0.0, 1.0, 1.0)

    # --- behavior toggles ---
    publish_map_transform: bool = True
    reset_map_on_optimize: bool = True
    verbosity: int = 1
    # per-scan intermediate clouds in SlamOutput.debug (not ported yet)
    collect_debug: bool = False

    # --- numerics ---
    dtype: str = "float32"

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)

    @property
    def has_laser_extrinsic(self) -> bool:
        """True when a non-identity laser→robot extrinsic is configured."""
        return self.laser_extrinsic_t != (0.0, 0.0, 0.0) or self.laser_extrinsic_q != (
            1.0, 0.0, 0.0, 0.0,
        )


# the original ROS yaml's key names → SlamConfig fields
_REFERENCE_KEY_ALIASES = {
    "verbosity_level": "verbosity",
    "octree_resolution": "map_resolution",
    "icp_information_matrix": "icp_information",
    "wheel_odom_information_matrix": "odometry_information",
    "loop_information_matrix": "loop_information",
}
_REFERENCE_IGNORED_KEYS = {"world_frame"}


def from_dict(data: dict, **overrides) -> SlamConfig:
    """Build a SlamConfig from a plain dict: field names (``icp_odometry`` /
    ``icp_mapping`` as nested dicts) or the original yaml's keys. Unknown
    keys raise."""
    fields = {f.name for f in dataclasses.fields(SlamConfig)}
    kw = {}
    for key, val in data.items():
        key = _REFERENCE_KEY_ALIASES.get(key, key)
        if key in _REFERENCE_IGNORED_KEYS:
            continue
        if key not in fields:
            raise KeyError(f"unknown config key '{key}'")
        if key in ("icp_odometry", "icp_mapping"):
            if not isinstance(val, dict):
                raise TypeError(f"{key} must be a mapping of IcpConfig fields")
            icp_fields = {f.name for f in dataclasses.fields(IcpConfig)}
            bad = set(val) - icp_fields
            if bad:
                raise KeyError(f"unknown {key} keys {sorted(bad)}")
            val = IcpConfig(**val)
        elif isinstance(val, list):
            val = tuple(float(x) for x in val)
        kw[key] = val
    kw.update(overrides)
    return SlamConfig(**kw)


def from_yaml(path: str, **overrides) -> SlamConfig:
    """Load a SlamConfig from a YAML file (needs PyYAML); ``overrides``
    replace fields after loading."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return from_dict(data, **overrides)


def _to_plain(x):
    if isinstance(x, tuple):
        return [_to_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _to_plain(v) for k, v in x.items()}
    return x


def save_yaml(config: SlamConfig, path: str) -> None:
    """Write a config as YAML (round-trips through ``from_yaml``)."""
    import yaml

    d = _to_plain(dataclasses.asdict(config))
    with open(path, "w") as f:
        yaml.safe_dump(d, f, sort_keys=False)


def kitti_config(**overrides) -> SlamConfig:
    """Velodyne/urban operating point (KITTI and the KITTI-proxy sequence):
    voxel leaf 0.4 m, correspondence distance 2.0 m, keyframe gate 2.0 m,
    loop radius 15 m with an id gap of 20, capacities for 80 m-range scans."""
    cfg = SlamConfig(
        voxel_leaf_size=0.4,
        map_resolution=0.4,
        icp_odometry=IcpConfig(
            mode="plane", max_iterations=10,
            max_correspondence_distance=2.0, huber_delta=1.0,
        ),
        icp_mapping=IcpConfig(
            mode="plane", max_iterations=30,
            max_correspondence_distance=2.0, huber_delta=1.0,
        ),
        keyframe_distance=2.0,
        loop_closure_radius=15.0,
        loop_closure_min_id_gap=20,
        loop_closure_candidates=2,
        max_points=8192,
        max_raw_points=131072,
        max_map_points=262144,
        max_keyframes=512,
        max_edges=2048,
    )
    return cfg.replace(**overrides) if overrides else cfg


def tiny_config(**overrides) -> SlamConfig:
    """Small-capacity config for tests and dry runs."""
    cfg = SlamConfig(
        max_points=256,
        max_raw_points=1024,
        max_map_points=4096,
        max_keyframes=32,
        max_edges=128,
    )
    return cfg.replace(**overrides) if overrides else cfg


__all__ = [
    "SlamConfig", "IcpConfig", "kitti_config", "tiny_config",
    "from_dict", "from_yaml", "save_yaml",
]
