"""The port's ``parallel/`` across processes: two gloo ranks on the CPU.

Two Python subprocesses join one process group through a ``FileStore``
in the test's temporary directory (``multihost.initialize`` with a
``file://`` address, a 60 s init timeout; each subprocess is given at most
120 s), hold D = 4 shards between them (2 each) and check that:

- ``psum``, ``pmin`` and ``all_gather_tiled`` reduce over every shard of
  both ranks, and ``replicate_to_global`` broadcasts rank 0's tensor;
- the sharded map's insert gives each rank the shards that one process
  holding all 4 computes (bit for bit), and ``approx_nn`` the same
  replicated answer (bit for bit: a minimum and a sum with one non-zero
  term are exact in any order);
- a ``dist-direct`` solve equals the one-process mesh's within 1e-6 m
  (the partial normal equations are summed in another order).

And ``initialize`` with an explicit address where nobody listens raises
instead of leaving the process single.
"""

import torch

# one intra-op thread per test worker: the suite runs several pytest
# workers on the host's cores beside XLA's own pool
torch.set_num_threads(1)

import importlib.util
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent

WORKER = textwrap.dedent('''
    import sys

    import numpy as np
    import torch

    torch.set_num_threads(1)

    from icpslam_tpu_torch.cloud.pointcloud import PointCloud
    from icpslam_tpu_torch.geometry import se3
    from icpslam_tpu_torch.geometry.se3 import Pose
    from icpslam_tpu_torch.graph import pose_graph as pg
    from icpslam_tpu_torch.parallel import dist_graph, multihost, sharded_map as sm
    from icpslam_tpu_torch.parallel import mesh as mesh_lib

    RES = 0.4


    def compute(mesh):
        """The shared workload on ``mesh`` (4 shards); numpy results."""
        rng = np.random.RandomState(0)
        smap = sm.empty_sharded_map(256, mesh.local, device="cpu")
        for _ in range(2):
            pts = torch.from_numpy(rng.uniform(-6, 6, (512, 3)).astype(np.float32))
            mask = torch.from_numpy(np.arange(512) < 450)
            smap = sm.insert(smap, PointCloud(pts, mask), RES, mesh)
        q = torch.from_numpy(rng.uniform(-7, 7, (128, 3)).astype(np.float32))
        nn = sm.approx_nn(smap, q, torch.ones(128, dtype=torch.bool), RES, mesh)

        n = 16
        ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
        t = np.c_[5 * np.cos(ang), 5 * np.sin(ang), np.zeros(n)].astype(np.float32)
        yaw = ang + np.pi / 2
        qq = np.c_[np.cos(yaw / 2), np.zeros(n), np.zeros(n), np.sin(yaw / 2)].astype(np.float32)
        gt = Pose(torch.from_numpy(t), torch.from_numpy(qq))
        edges = pg.empty_edges(21)
        for k in range(n):
            a, b = k, (k + 1) % n
            edges = pg.add_edge(edges, a, b, se3.relative(se3.index(gt, a), se3.index(gt, b)),
                                100 * torch.eye(6))
        drift = torch.from_numpy(np.cumsum(rng.randn(n, 6) * 0.02, 0).astype(np.float32))
        noisy = se3.normalize(se3.compose(gt, se3.se3_exp(drift)))
        opt, stats = dist_graph.optimize(noisy, edges, torch.ones(n, dtype=torch.bool), mesh,
                                         iterations=5, mode="lm", linear_solver="direct")
        out = {"map_" + f: getattr(smap, f).numpy() for f in smap._fields}
        out.update(nn_points=nn.points.numpy(), nn_dist2=nn.dist2.numpy(),
                   nn_found=nn.found.numpy(), opt_t=opt.t.numpy(), opt_q=opt.q.numpy(),
                   cost=stats.final_cost.numpy())
        return out


    if __name__ == "__main__":
        store, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
        multihost.initialize("file://" + store, num_processes=2, process_id=rank,
                             device="cpu", timeout_s=60)
        mesh = mesh_lib.make_mesh(4, device="cpu")
        assert (mesh.world, mesh.rank, mesh.local) == (2, rank, 2), mesh
        assert multihost.is_coordinator() == (rank == 0)
        ids = mesh.shard_ids().to(torch.float32)          # this rank's global shard ids
        assert float(mesh.psum(ids + 1.0)) == 10.0         # 1 + 2 + 3 + 4
        assert float(mesh.pmin(ids[:, None] + 5.0)[0]) == 5.0
        assert mesh.all_gather_tiled(ids).tolist() == [0.0, 1.0, 2.0, 3.0]
        got = multihost.replicate_to_global(torch.full((2,), float(rank + 7)), mesh)
        assert got.tolist() == [7.0, 7.0]
        np.savez(out, **compute(mesh))
        torch.distributed.destroy_process_group()
        print(f"rank{rank}: OK")
''')


def _load_worker(path: Path):
    spec = importlib.util.spec_from_file_location("multihost_worker", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_two_gloo_ranks_equal_one_process(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    store = tmp_path / "store"
    outs = [tmp_path / f"rank{r}.npz" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, str(worker), str(store), str(r), str(outs[r])],
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
        assert f"rank{r}: OK" in log, log

    from icpslam_tpu_torch.parallel import mesh as mesh_lib

    one = _load_worker(worker).compute(mesh_lib.make_mesh(4, device="cpu"))
    ranks = [dict(np.load(o)) for o in outs]
    for f in ("keys", "points", "size", "overflow"):
        both = np.concatenate([r["map_" + f] for r in ranks])
        np.testing.assert_array_equal(both, one["map_" + f], err_msg=f)
    assert one["map_size"].sum() > 0
    for r in ranks:
        for f in ("nn_points", "nn_dist2", "nn_found"):
            np.testing.assert_array_equal(r[f], one[f], err_msg=f)
        np.testing.assert_allclose(r["opt_t"], one["opt_t"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(r["opt_q"], one["opt_q"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(r["cost"], one["cost"], rtol=1e-4)
    assert one["nn_found"].any()


def test_initialize_explicit_failure_raises():
    code = textwrap.dedent('''
        from icpslam_tpu_torch.parallel import multihost
        try:
            multihost.initialize("127.0.0.1:1", num_processes=2, process_id=1, device="cpu",
                                 timeout_s=3)
        except Exception as e:
            print("raised", type(e).__name__)
        else:
            print("no error")
    ''')
    res = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert "raised" in res.stdout, res.stdout + res.stderr


def test_initialize_without_cluster_runs_single(monkeypatch):
    from icpslam_tpu_torch.parallel import mesh as mesh_lib
    from icpslam_tpu_torch.parallel import multihost

    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    multihost.initialize(device="cpu")
    assert not torch.distributed.is_initialized()
    assert multihost.is_coordinator()
    m = multihost.global_mesh(device="cpu")
    assert (m.size, m.world, m.local, m.group) == (1, 1, 1, None)
    with pytest.raises(ValueError, match="multiple"):
        mesh_lib.Mesh(size=3, group=None, world=2, rank=0, device=torch.device("cpu"))
