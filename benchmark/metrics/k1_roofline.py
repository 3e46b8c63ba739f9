"""K1 (``csrc/nn1.cu``): the bytes its calls need at the card's memory
bandwidth over their device time, % (``yardstick/roofline.py``)."""
from yardstick import trace


def read(ctx):
    return trace.roofline_pct(ctx.profiled.trace, "k1") if ctx.profiled else None
