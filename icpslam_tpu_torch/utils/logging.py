"""Leveled logger (port of ``icpslam_tpu/utils/logging.py``).

The reference's ``verbosity_level_`` mechanism without ROS: one typed
config field (``SlamConfig.verbosity``) and the same stderr format as the
JAX package, ``[icpslam <seconds>s <TAG>] message``.
"""

from __future__ import annotations

import sys
import time


class Logger:
    """level 0 = silent, 1 = info/warn, 2 = debug (the reference's dump level)."""

    def __init__(self, level: int = 1, stream=None, name: str = "icpslam"):
        self.level = level
        self.stream = stream or sys.stderr
        self.name = name
        self._t0 = time.perf_counter()

    def _emit(self, tag: str, msg: str) -> None:
        dt = time.perf_counter() - self._t0
        print(f"[{self.name} {dt:8.2f}s {tag}] {msg}", file=self.stream)

    def info(self, msg: str) -> None:
        if self.level >= 1:
            self._emit("INFO", msg)

    def warn(self, msg: str) -> None:
        if self.level >= 1:
            self._emit("WARN", msg)

    def debug(self, msg: str) -> None:
        if self.level >= 2:
            self._emit("DEBUG", msg)
