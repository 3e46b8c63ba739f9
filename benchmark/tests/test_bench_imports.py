"""The check that a run loads nothing of JAX or the JAX package, and the
runs that must exit with no result."""

import os
import shutil
import subprocess
import sys

from yardstick import imports, spec


def test_top_level_names_are_compared_whole():
    assert imports.forbidden(["icpslam_tpu_torch", "icpslam_tpu_torch.io.runner",
                              "jaxtyping", "flaxen.x", "numpy"]) == []
    assert imports.forbidden(["icpslam_tpu.ops.nn"]) == ["icpslam_tpu"]
    assert imports.forbidden(["jax._src.core", "jaxlib", "flax.linen", "torch"]) == [
        "flax", "jax", "jaxlib"]


def test_the_harness_and_reference_load_nothing_forbidden():
    """Importing the whole yardstick, the reference and the program they
    drive, in a fresh interpreter, loads no forbidden module."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from yardstick import bench, drive, reference, compare, trace\n"
            "import slamref.pipeline.slam\n"
            "from yardstick import imports\n"
            "print(imports.forbidden(sys.modules))\n") % (spec.BENCH_DIR, spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run(cwd, *extra):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "kitti_hdl64.revisit",
                           "--seed", "4000000001", "--seconds", "1", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = _run(spec.ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
