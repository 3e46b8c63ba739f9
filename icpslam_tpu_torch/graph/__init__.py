"""Keyframes and the pose graph (the exports of ``icpslam_tpu/graph/__init__.py``)."""

from icpslam_tpu_torch._exports import lazy

__getattr__, __dir__, __all__ = lazy(
    __name__, ("keyframes", "pose_graph", "marginalize", "schur", "captured"), {})
