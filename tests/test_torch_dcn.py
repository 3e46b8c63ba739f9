"""The port's two-rank tools (``icpslam_tpu_torch/tools/scaling_dcn.py``,
``elastic_dcn.py``) on the CPU: two gloo ranks in subprocesses, each on
one thread (``OMP_NUM_THREADS=1``), at reduced scan sizes (300 points in
a 512-point capacity; the tools pass ``_dcn.POINTS`` and
``_dcn.CAPACITY`` to their ranks).

- ``scaling_dcn --device cpu`` runs end to end, with a rung that has
  every key of JAX's artifact;
- ``elastic_dcn --device cpu`` is not degraded without a fault, and with
  ``--inject-fault crash --watchdog 15`` detects the dead rank, ends the
  survivor and re-dispatches the workload in one process, leaving no
  rank process alive;
- with no card, ``--device cuda`` exits with an error naming the card
  count before any rank is spawned.
"""

import torch

# one intra-op thread per test worker: the suite runs several pytest
# workers on the host's cores beside XLA's own pool
torch.set_num_threads(1)

import json
import os
from pathlib import Path

import pytest

from icpslam_tpu_torch.tools import _dcn, elastic_dcn, scaling_dcn

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(_dcn, "POINTS", 300)
    monkeypatch.setattr(_dcn, "CAPACITY", 512)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_scaling_dcn_two_gloo_ranks(tmp_path, small):
    out = tmp_path / "scaling.json"
    assert scaling_dcn.main(["--device", "cpu", "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    jax_art = json.loads((REPO / "artifacts" / "scaling_dcn2.json").read_text())
    assert set(jax_art) <= set(art), sorted(set(jax_art) - set(art))
    assert (art["processes"], art["global_devices"], art["pairs"], art["points"]) == (2, 4, 4, 300)
    assert art["step_ms"] > 0 and art["compute_ms"] > 0 and 0 <= art["collective_frac"] < 1
    assert art["poses_finite"] and art["card"] == {"device": "cpu"}
    assert art["backend"].startswith("cpu")


def test_elastic_dcn_healthy(tmp_path, small):
    out = tmp_path / "elastic.json"
    assert elastic_dcn.main(["--device", "cpu", "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    assert art["degraded"] is False and "failure" not in art
    assert art["distributed"]["processes"] == 2 and art["distributed"]["poses_finite"]
    assert not any(_alive(p) for p in art["worker_pids"])


def test_elastic_dcn_crash_redispatches(tmp_path, small):
    out = tmp_path / "elastic.json"
    assert elastic_dcn.main(["--device", "cpu", "--inject-fault", "crash", "--watchdog", "15",
                             "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    assert art["degraded"] is True and art["failure"]
    assert "41" in art["failure"] or "watchdog" in art["failure"]
    red = art["redispatch"]
    assert red["mode"] == "single_process_degraded" and red["processes"] == 1
    assert red["shards"] == 4 and red["poses_finite"]
    assert not any(_alive(p) for p in art["worker_pids"])


@pytest.mark.parametrize("tool", ["scaling_dcn", "elastic_dcn"])
def test_cuda_without_cards_refused_before_spawning(tool, tmp_path, monkeypatch):
    if torch.cuda.is_available() and torch.cuda.device_count() >= _dcn.RANKS:
        pytest.skip("this machine has a card per rank")
    spawned = []
    monkeypatch.setattr(scaling_dcn.subprocess, "Popen", lambda *a, **k: spawned.append(a))
    mod = {"scaling_dcn": scaling_dcn, "elastic_dcn": elastic_dcn}[tool]
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(SystemExit, match=f"this machine has {n}"):
        mod.main(["--device", "cuda", "--out", str(tmp_path / "x.json")])
    assert not spawned and not (tmp_path / "x.json").exists()


def test_run_single_on_the_cpu():
    res = elastic_dcn.run_single("cpu", n_points=300, capacity=512)
    assert res["mode"] == "single_process_degraded" and res["poses_finite"]
    assert res["shards"] == 4 and res["pairs"] == 4 and res["step_ms"] > 0
