"""Scan prefetch: prepare and upload scans ahead of the step (port of
``icpslam_tpu/io/prefetch.py``).

``prefetch(iterable, prep, depth)`` yields ``prep(item)`` for each item,
computed ``depth`` items ahead on a background thread; the producer's
exception is raised in the consumer, and the queue is bounded. Unlike
the JAX version, the worker stops when the consumer leaves: closing the
generator (``close()``, ``break`` out of a ``for`` over it, or its
garbage collection) sets a stop flag, the worker finishes the item in hand,
closes the source iterator and ends, and ``close`` joins it.

``Uploader`` is the CUDA half of the runner's ``prep``. On the worker it
copies a scan's numpy arrays into a ring of pinned host buffers and
uploads them with ``non_blocking=True`` on a dedicated
``torch.cuda.Stream``, recording an event after the upload; a pinned
slot is written again only after the event of its last upload has
completed. On the consumer, ``ready`` makes the current stream wait for
that event and calls ``record_stream`` on the tensors, so the caching
allocator does not hand their memory to the side stream again while the
main stream still reads them. On the CPU ``upload`` wraps the arrays
without a copy and ``ready`` returns them.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

_STOP = object()


def prefetch(iterable: Iterable, prep: Callable, depth: int = 3) -> Iterator:
    """Yield ``prep(item)`` for each item, ``depth`` ahead on a thread.
    ``depth <= 0`` maps inline."""
    if depth <= 0:
        for item in iterable:
            yield prep(item)
        return

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    err = []
    source = iter(iterable)

    def put(x) -> bool:
        while not stop.is_set():
            try:
                q.put(x, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for item in source:
                if stop.is_set() or not put(prep(item)):
                    break
        except BaseException as e:  # noqa: BLE001 — raised again in the consumer
            err.append(e)
        finally:
            close = getattr(source, "close", None)
            if close is not None:
                close()
            put(_STOP)

    t = threading.Thread(target=worker, name="scan-prefetch", daemon=True)
    t.start()
    try:
        while True:
            x = q.get()
            if x is _STOP:
                if err:
                    raise err[0]
                return
            yield x
    finally:
        stop.set()
        t.join()


class Uploader:
    """Pinned staging and side-stream upload of numpy arrays to ``device``."""

    def __init__(self, device, slots: int = 5):
        device = torch.device(device)
        self.cuda = device.type == "cuda"
        if self.cuda and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        if self.cuda:
            self.stream = torch.cuda.Stream(device)
            self._pinned: list = [None] * slots
            self._done: list = [None] * slots
            self._next = 0

    def upload(self, arrays: Sequence[np.ndarray]) -> Tuple[Tuple[torch.Tensor, ...], Optional[object]]:
        """``(tensors on the device, the upload's event or None)``; on CUDA
        the copy is enqueued on the side stream and not waited for."""
        if not self.cuda:
            return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays), None
        slot = self._next % len(self._pinned)
        self._next += 1
        if self._done[slot] is not None:
            self._done[slot].synchronize()  # the last copy out of this slot has finished
        pinned = self._pinned[slot]
        if pinned is None or any(p.shape != a.shape for p, a in zip(pinned, arrays)):
            pinned = tuple(torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype,
                                       pin_memory=True) for a in arrays)
            self._pinned[slot] = pinned
        for p, a in zip(pinned, arrays):
            p.numpy()[...] = a
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = tuple(p.to(self.device, non_blocking=True) for p in pinned)
            done = torch.cuda.Event()
            done.record(self.stream)
        self._done[slot] = done
        return out, done

    def ready(self, tensors: Tuple[torch.Tensor, ...], event) -> Tuple[torch.Tensor, ...]:
        """On the consumer's thread: order the current stream after the
        upload and tie the tensors' memory to it."""
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in tensors:
                t.record_stream(current)
        return tensors
