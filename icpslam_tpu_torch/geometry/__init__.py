"""SE(3) and quaternion algebra (the exports of ``icpslam_tpu/geometry/__init__.py``)."""

from icpslam_tpu_torch._exports import lazy

__getattr__, __dir__, __all__ = lazy(__name__, ("quaternion", "se3"), {"Pose": "se3"})
