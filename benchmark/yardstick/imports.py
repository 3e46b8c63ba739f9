"""The check that a run loaded nothing of JAX or of the JAX package.

Module names are compared by their top-level name (the part before the
first dot), whole: ``icpslam_tpu_torch`` begins with ``icpslam_tpu`` and
is not it.
"""

from __future__ import annotations

from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "icpslam_tpu")


def forbidden(module_names: Iterable[str]) -> List[str]:
    """The sorted top-level names among ``module_names`` that are
    forbidden."""
    tops = {name.split(".", 1)[0] for name in module_names}
    return sorted(tops.intersection(FORBIDDEN))
