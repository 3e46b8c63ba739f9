"""ctypes bindings over the native scan reader (port of
``icpslam_tpu/io/native_loader.py``).

The C++ source is the repository's ``native/scanio.cpp``: buffered ``.bin``
reading, range gating, an even-stride subsample to capacity, and a
prefetcher whose worker threads read files ahead through a bounded,
in-order ring. The port builds its own shared library from that source at
first use (``g++ -O3 -shared -fPIC -pthread``) into
``icpslam_tpu_torch/_build/`` (git-ignored), named by a hash of the source
and the flags, beside ``ops/cuda_build.py``'s kernels. It never loads a
library built for the JAX package. ctypes releases the GIL in every call,
so the reads and the wait for the next scan leave the Python threads free.

``available()`` says whether the library built and loaded. ``scan_stream``
falls back to the Python reader (``io/kitti.py``) without it, as JAX's
does; the runner's summary says which one ran (``"loader"``). The Python
reader subsamples with ``RandomState(seed=i)``, the native one by an even
stride: both are the JAX package's semantics.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from icpslam_tpu_torch.io import kitti
from icpslam_tpu_torch.io.synthetic import pad

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "scanio.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_FP = ctypes.POINTER(ctypes.c_float)


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libscanio_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp.so"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {out.name} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises on failure."""
    out = library_path()
    if not out.exists():
        _build(out)
    lib = ctypes.CDLL(str(out))
    lib.scanio_read_bin.restype = ctypes.c_int
    lib.scanio_read_bin.argtypes = [
        ctypes.c_char_p, _FP, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
    ]
    lib.scanio_prefetcher_create.restype = ctypes.c_void_p
    lib.scanio_prefetcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ]
    lib.scanio_prefetcher_next.restype = ctypes.c_int
    lib.scanio_prefetcher_next.argtypes = [ctypes.c_void_p, _FP]
    lib.scanio_prefetcher_destroy.restype = None
    lib.scanio_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    """Whether the native library builds and loads here."""
    try:
        load()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def _scan(buf: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    mask = np.zeros((buf.shape[0],), bool)
    mask[:n] = True
    return buf, mask


def read_scan(path: str, capacity: int, record_stride: int = 4, min_range: float = 2.5,
              max_range: float = 80.0) -> Tuple[np.ndarray, np.ndarray]:
    """One scan read natively into a padded ``(points, mask)`` pair."""
    buf = np.zeros((capacity, 3), np.float32)
    n = load().scanio_read_bin(path.encode(), buf.ctypes.data_as(_FP), capacity,
                               record_stride, min_range, max_range)
    if n < 0:
        raise IOError(f"native read failed for {path}")
    return _scan(buf, n)


class PrefetchingLoader:
    """Padded ``(points, mask)`` scans with native read-ahead (``threads``
    workers, ``depth`` scans ahead, in order). ``close`` stops the workers."""

    def __init__(self, paths: Sequence[str], capacity: int, record_stride: int = 4,
                 min_range: float = 2.5, max_range: float = 80.0, threads: int = 2,
                 depth: int = 4):
        self._lib = load()
        self._capacity = capacity
        self._n = len(paths)
        self._encoded = [p.encode() for p in paths]  # alive as long as the workers
        arr = (ctypes.c_char_p * self._n)(*self._encoded)
        self._handle = self._lib.scanio_prefetcher_create(
            arr, self._n, capacity, record_stride, ctypes.c_float(min_range),
            ctypes.c_float(max_range), threads, depth,
        )
        if not self._handle:
            raise RuntimeError("failed to create the native prefetcher")

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for k in range(self._n):
            buf = np.zeros((self._capacity, 3), np.float32)
            n = self._lib.scanio_prefetcher_next(self._handle, buf.ctypes.data_as(_FP))
            if n == -2:
                break
            if n < 0:
                # a bad file is an error, as in the Python reader
                raise IOError(f"native read failed for scan #{k}")
            yield _scan(buf, n)

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.scanio_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def scan_stream(root: str, seq: str, capacity: int, threads: int = 2, depth: int = 4,
                start: int = 0, end: Optional[int] = None, with_stamps: bool = False,
                use_native: Optional[bool] = None):
    """The KITTI stream ``[start, end)``: padded ``(points, mask)`` scans, or
    ``((points, mask), stamp)`` pairs with ``with_stamps`` (times.txt, or a
    10 Hz counter without it). ``use_native`` None takes the native
    prefetching loader when ``available()``, else the Python reader."""
    files: List[str] = kitti.scan_files(root, seq)[start:end]
    stamps = kitti.stamps_for(root, seq, start, len(files), end) if with_stamps else None
    if use_native is None:
        use_native = available()
    loader = PrefetchingLoader(files, capacity, threads=threads, depth=depth) if use_native else None
    it = iter(loader) if loader is not None else (
        pad(kitti.read_scan(f, max_points=capacity, seed=i), capacity)
        for i, f in enumerate(files)
    )
    try:
        for i, scan in enumerate(it):
            yield (scan, float(stamps[i])) if with_stamps else scan
    finally:
        if loader is not None:
            loader.close()
