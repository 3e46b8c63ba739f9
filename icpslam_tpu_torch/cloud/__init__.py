"""Point clouds and the voxel filter (the exports of ``icpslam_tpu/cloud/__init__.py``)."""

from icpslam_tpu_torch._exports import lazy

__getattr__, __dir__, __all__ = lazy(__name__, ("pointcloud", "voxel", "deskew"), {
    **dict.fromkeys(("PointCloud", "empty", "from_points", "to_numpy", "transform",
                     "masked_centroid"), "pointcloud"),
    **dict.fromkeys(("voxel_downsample", "voxel_coords"), "voxel"),
})
