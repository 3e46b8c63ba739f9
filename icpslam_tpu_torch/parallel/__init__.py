"""Sharded execution over a mesh of shards (port of ``icpslam_tpu/parallel/``):
``mesh``, ``multihost``, ``sharded_nn``, ``sharded_map``, ``dist_graph``,
``dist_step`` and ``scaling``. Unlike JAX's package this one imports no
submodule: ``mapping/backend.py`` imports ``sharded_map``, and
``dist_step`` imports the pipeline above ``mapping/``, so importing them
all here would make a cycle."""
