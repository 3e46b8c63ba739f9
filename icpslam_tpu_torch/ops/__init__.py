"""Registration operators and the kernels' wrappers (the exports of
``icpslam_tpu/ops/__init__.py``). Importing builds no kernel: each wrapper
builds its kernel at its first launch on the card."""

from icpslam_tpu_torch._exports import lazy

__getattr__, __dir__, __all__ = lazy(
    __name__, ("nn", "kabsch", "covariance", "icp", "linalg3", "radius_stats", "skew_icp",
               "cuda_build"), {"IcpResult": "icp"})
