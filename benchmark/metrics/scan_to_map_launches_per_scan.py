"""Kernel and graph launch calls per window scan made inside scan-to-map
(``scan_to_map.refine`` and the spans under it): each runtime call on the
innermost program span open on its thread, from the profiler's trace
(``yardstick/layers.py``)."""
from yardstick import layers


def read(ctx):
    return layers.launches_per_scan(ctx.profiled, layers.SCAN_TO_MAP)
