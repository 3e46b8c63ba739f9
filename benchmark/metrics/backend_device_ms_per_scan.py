"""Device ms per window scan of the kernels, copies and memsets launched
inside the back end (``loop_closure.verify``, ``graph.solve`` and the spans
under them): each device op on the span of the call that launched it, from
the profiler's trace (``yardstick/layers.py``)."""
from yardstick import layers


def read(ctx):
    return layers.device_ms_per_scan(ctx.profiled, layers.BACKEND)
