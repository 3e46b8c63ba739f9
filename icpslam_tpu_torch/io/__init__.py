"""Scan sources and the runner (the exports of ``icpslam_tpu/io/__init__.py``)."""

from icpslam_tpu_torch._exports import lazy

__getattr__, __dir__, __all__ = lazy(
    __name__, ("synthetic", "kitti", "live", "native_loader", "prefetch", "runner"), {})
