"""Counted host reads.

Every place where the port's host control flow needs a device value (the
counterparts of the JAX package's ``lax.cond`` / ``while_loop``
predicates) reads it through :func:`to_host`. On a CUDA tensor each call
is one device synchronisation; ``to_host.count`` counts them, and so
does the counter ``host_syncs`` (``utils/profiling.py``; by span while
tracing is on), so a run can report host syncs per scan and per layer.
Syncs that PyTorch makes on its own (a blocking host-to-device copy, a
Python scalar written into a CUDA tensor, a stream synchronize) are not
counted here; ``chip_smoke.py``
phase 12 counts them with ``torch.cuda.set_sync_debug_mode("warn")``.
"""

from __future__ import annotations

import numpy as np
import torch

from icpslam_tpu_torch.utils import profiling


def to_host(t: torch.Tensor) -> np.ndarray:
    """Copy ``t`` to a host numpy array (one device sync on CUDA)."""
    to_host.count += 1
    profiling.count("host_syncs")
    return t.detach().cpu().numpy()


to_host.count = 0
