"""Gauss-Newton iterations per window scan inside scan-to-map
(``scan_to_map.refine`` and the spans under it): the program's counter
``icp.iterations`` by span (``yardstick/layers.py``)."""
from yardstick import layers


def read(ctx):
    return layers.count_per_scan(ctx.profiled, "icp.iterations", layers.SCAN_TO_MAP)
