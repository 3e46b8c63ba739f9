"""The benchmark's plain reference for the SLAM step.

A frozen copy of the plain PyTorch path of ``slam_step`` (odometry with
the voxel filter, GICP covariances and the de-skew solve, scan-to-map and
the point map, keyframes, loop closure, the pose-graph solves), with
every nearest-neighbour search in its blocked plain form, the graph
solves eager, and no kernel, CUDA graph, shard or mesh. It imports
``torch`` alone. It takes the same scans and configuration values as the
system under test and nothing that the system made; the benchmark runs
it after the measured window and compares its per-scan records with the
system's (``yardstick/compare.py``).

It is kept apart from the system's package so that a change to the
system cannot move the yardstick; a change that alters the step's
arithmetic on purpose brings a matching change here in a benchmark PR.
"""
