"""Gauss-Newton iterations per window scan inside the odometry
(``odometry.step`` and the spans under it): the program's counter
``icp.iterations`` by span (``yardstick/layers.py``)."""
from yardstick import layers


def read(ctx):
    return layers.count_per_scan(ctx.profiled, "icp.iterations", layers.ODOMETRY)
