"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface; ``nvcc`` compiles each source for
``sm_90a`` to an object, all sources at once in parallel processes, and
links the objects into one shared library, loaded with ``ctypes``. The
library is built at first use, from the sources in the package only, into
``icpslam_tpu_torch/_build/`` (git-ignored); its file name carries a hash
of the sources and flags, so an edited source rebuilds it. Nothing is
built or imported when this module is imported — the CPU tests import
every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from icpslam_tpu_torch.utils import profiling

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("nn1.cu", "knn.cu", "radius_moments.cu", "nn1_matmul.cu")
HEADERS = ("nn_tiles.cuh",)  # included by every source
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libicpslam_kernels_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
@profiling.spanned("cuda_build.load")
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure.

    Sets ``load.build_seconds`` (0.0 when an up-to-date library existed)
    and ``load.log`` (path of the compiler output, with ``-Xptxas -v``
    register and shared-memory usage).
    """
    out = library_path()
    log = out.with_suffix(".log")
    t0 = time.perf_counter()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{out.stem}.{os.getpid()}"
        nvcc = _nvcc()
        objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
        cmds = [
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
            for s, o in zip(SOURCES, objs)
        ]
        procs = [
            subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for c in cmds
        ]
        outs = [p.communicate()[0] for p in procs]
        tmp = BUILD_DIR / f"{tag}.tmp.so"
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", str(tmp), *(str(o) for o in objs)]
        linked = None
        if all(p.returncode == 0 for p in procs):
            linked = subprocess.run(link, capture_output=True, text=True)
        text = "".join(" ".join(c) + "\n" + o for c, o in zip(cmds, outs))
        if linked is not None:
            text += " ".join(link) + "\n" + linked.stdout + linked.stderr
        log.write_text(text)
        for o in objs:
            o.unlink(missing_ok=True)
        if linked is None or linked.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{text}")
        os.replace(tmp, out)
    load.build_seconds = time.perf_counter() - t0
    load.log = log
    lib = ctypes.CDLL(str(out))
    lib.icpslam_nn1.argtypes = [_P, _P, _P, _P, _P, _I, _I, _P, _L, _P, _P, _P, _P]
    lib.icpslam_nn1.restype = _I
    lib.icpslam_knn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P, _L, _P, _P, _P, _P]
    lib.icpslam_knn.restype = _I
    lib.icpslam_nn_scratch_floats.argtypes = [_I]
    lib.icpslam_nn_scratch_floats.restype = _L
    lib.icpslam_radius_moments.argtypes = [_P, _P, _P, _P, _I, _I, _F, _F, _P, _L, _P, _P,
                                           _P, _P, _P]
    lib.icpslam_radius_moments.restype = _I
    lib.icpslam_nn1_matmul.argtypes = [_P, _P, _P, _P, _P, _I, _I, _P, _L, _P, _P, _P]
    lib.icpslam_nn1_matmul.restype = _I
    lib.icpslam_nn1_matmul_scratch_floats.argtypes = [_I]
    lib.icpslam_nn1_matmul_scratch_floats.restype = _L
    return lib


def check(code: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")
