"""Sharded execution over a mesh of shards (port of ``icpslam_tpu/parallel/``):
``mesh``, ``multihost``, ``sharded_nn``, ``sharded_map``, ``dist_graph``,
``dist_step`` and ``scaling``. JAX's package imports its submodules here;
this one exports the same names but loads each at first use
(``_exports.lazy``): ``mapping/backend.py`` imports ``sharded_map``, and
``dist_step`` imports the pipeline above ``mapping/``, so importing them
all here would make a cycle."""

from icpslam_tpu_torch._exports import lazy

__getattr__, __dir__, __all__ = lazy(
    __name__, ("mesh", "dist_graph", "dist_step", "multihost", "sharded_map", "sharded_nn",
               "scaling"), {})
