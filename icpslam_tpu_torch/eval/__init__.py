"""Trajectory metrics (the exports of ``icpslam_tpu/eval/__init__.py``)."""

from icpslam_tpu_torch._exports import lazy

__getattr__, __dir__, __all__ = lazy(__name__, ("metrics",), {})
