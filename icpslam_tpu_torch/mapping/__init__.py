"""The maps and scan-to-map refinement (the exports of ``icpslam_tpu/mapping/__init__.py``)."""

from icpslam_tpu_torch._exports import lazy

__getattr__, __dir__, __all__ = lazy(
    __name__, ("backend", "point_map", "voxel_map", "scan_to_map"),
    dict.fromkeys(("VoxelMap", "empty_map"), "voxel_map"))
