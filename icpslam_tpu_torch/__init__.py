"""icpslam_tpu_torch — the PyTorch + CUDA port of ``icpslam_tpu``.

Mirrors the JAX package's layout and names (``geometry/se3.py``,
``ops/nn.py``, ``pipeline/slam.py``, ...) so each module's counterpart is
easy to find. It imports ``torch`` and never ``jax``; the JAX package stays
the reference the port is tested against.

The main path (``pipeline.slam.slam_step``) runs on an NVIDIA H100 through
two kernels written by hand in CUDA C++ (``csrc/nn1.cu``, ``csrc/knn.cu``),
built with ``nvcc`` at first use. On CPU tensors every kernel wrapper runs
its plain PyTorch version instead.

The package exports the JAX package's subpackages and ``SlamConfig``;
each subpackage exports its JAX counterpart's names and loads a module at
the first use of one of them (``_exports.py``).

Precision: float32 everywhere, with TF32 off for the whole package — the
counterpart of the JAX package forcing the highest matmul precision
(``icpslam_tpu/__init__.py``): reduced-precision distance products pick
the wrong neighbours (``docs/DESIGN.md`` §8).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from icpslam_tpu_torch import (  # noqa: E402,F401
    cloud, eval, geometry, graph, io, mapping, ops, parallel, pipeline, utils, viz,
)
from icpslam_tpu_torch.config import SlamConfig  # noqa: E402,F401

__version__ = "0.1.0"
