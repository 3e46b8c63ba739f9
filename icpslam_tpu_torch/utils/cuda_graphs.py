"""Capturing a piece of device work as a CUDA graph.

:func:`capture` is the one routine that the port's captured work goes
through: the pose-graph solves (``graph/captured.py``) and the coupled
de-skew GN iteration (``ops/skew_icp.py``). Each caller keeps its static
input buffers and the outputs of the captured call, copies new inputs
into the buffers and replays the graph on the current stream.
"""

from __future__ import annotations

from typing import Callable, Tuple, TypeVar

import torch

from icpslam_tpu_torch.utils import profiling

T = TypeVar("T")


@profiling.spanned("graph.capture")
def capture(fn: Callable[[], T], device) -> Tuple[torch.cuda.CUDAGraph, T]:
    """Run ``fn`` once on a side stream, then capture one more call of it
    as a CUDA graph on ``device``. Returns the graph and what the captured
    call returned: tensors that each replay writes anew. A failure
    raises."""
    # the warm-up and the capture run fn's Python body twice: the call
    # counters count replays, not these
    with profiling.paused():
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            # creates the cuBLAS / cuSOLVER handles and workspaces outside
            # the capture
            fn()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread-local capture: the runner's prefetch thread keeps copying
        # scans on its own stream meanwhile, and in the default global
        # mode any such call from another thread invalidates the capture
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outputs = fn()
    profiling.count("graph.captures")
    return graph, outputs
