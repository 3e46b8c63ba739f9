"""Checkpoints, frames, logging and profiling (the exports of
``icpslam_tpu/utils/__init__.py``)."""

from icpslam_tpu_torch._exports import lazy

__getattr__, __dir__, __all__ = lazy(
    __name__, ("checkpoint", "frames", "logging", "profiling", "device", "interop", "sync",
               "tree"), {"Logger": "logging"})
