"""Device ms per window scan of the kernels, copies and memsets launched
inside scan-to-map (``scan_to_map.refine`` and the spans under it): each
device op on the span of the call that launched it, from the profiler's
trace (``yardstick/layers.py``)."""
from yardstick import layers


def read(ctx):
    return layers.device_ms_per_scan(ctx.profiled, layers.SCAN_TO_MAP)
