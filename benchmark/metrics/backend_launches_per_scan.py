"""Kernel and graph launch calls per window scan made inside the back end
(``loop_closure.verify``, ``graph.solve`` and the spans under them): each
runtime call on the innermost program span open on its thread, from the
profiler's trace (``yardstick/layers.py``)."""
from yardstick import layers


def read(ctx):
    return layers.launches_per_scan(ctx.profiled, layers.BACKEND)
