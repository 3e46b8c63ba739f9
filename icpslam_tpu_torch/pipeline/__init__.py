"""The odometry front end, the SLAM step and the deferred solve (the exports of
``icpslam_tpu/pipeline/__init__.py``)."""

from icpslam_tpu_torch._exports import lazy

__getattr__, __dir__, __all__ = lazy(
    __name__, ("odometry", "robot_odometry", "slam", "deferred"), {})
