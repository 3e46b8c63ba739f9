#!/usr/bin/env python3
"""This checkout against another checkout of the repo, on one GPU, in one call.

    python3 chip_ab.py OTHER

OTHER is a directory inside this checkout that holds another checkout, for
example the parent commit unpacked with ``git archive`` into the
git-ignored ``_smoke_checkout/parent``; a path outside this checkout is
refused. Each run is a fresh process whose ``icpslam_tpu_torch`` is that
checkout's own, in the order other, this, this, other. A run builds the
checkout's kernels, then measures, with this checkout's ``chip_smoke.py``
timers and inputs:

- K1 (``nn1_cuda``) on the scan target (8192 × 8192) and the map target
  (8192 × 262,144 at ~22k fill), K2 (``knn_cuda``, self k = 10), K3
  (``radius_moments_cuda``, self 8192, r = 1.0 m, taper σ = 0.5 m and the
  hard cutoff) and K4 (``nn1_matmul_cuda``, the scan and the map cases), at
  the shapes of ``chip_smoke.py`` phases 2-3 and 6-7: device ms per call
  (``_device_ms``) and CUDA events around single calls (``_timed``);
- the 40-scan ``kitti_config()`` slice and the 500-scan radius mission
  through ``runner.run_slam``: median and p90 ms/scan, ATE, and the
  runner's accepted, keyframe, edge, loop-closure and solve counts
  (``same_path_counts`` says whether every run gave the same).

OTHER may also be a copy of this checkout with one kernel constant edited,
to time a variant: ``kTile`` in ``icpslam_tpu_torch/csrc/nn_tiles.cuh``
(K3's tile, and K1's and K2's, which must still give the same bytes) or
``kR`` in ``icpslam_tpu_torch/csrc/nn1_matmul.cu`` (K4's queries per warp).

It prints one line per run, then one JSON line with each checkout's runs and
how the two checkouts' kernel outputs compare: K1 and K2 must be equal byte
for byte; K3's hard counts equal and its moments within ``chip_smoke.py``'s
MOM_ABS + MOM_REL·|x|; K4's d² within its rounding tolerance K4_REL·(|q_c|²
+ |t_c|²) + K4_ABS, and a differing pick only where the two picks' exact d²
lie that close. It exits 1 if they do not. Both paths are host-bound, and
their times move with the host from call to call, so two checkouts are
compared only within one call.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.realpath(__file__))
SLICE_SCANS = 40
MISSION_SCANS = 500
# the runner's counts that each path records, compared between checkouts
PATH_COUNTS = ("accepted", "keyframes", "edges", "loop_closures", "window_solves", "full_solves")


def _smoke():
    """This checkout's ``chip_smoke.py``, loaded by path, so that its
    timers and inputs are the same for both checkouts."""
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _path(cfg, n, dev):
    import torch

    from icpslam_tpu_torch.geometry.se3 import Pose
    from icpslam_tpu_torch.io import runner

    stream, gt = runner.kitti_proxy_source(cfg, n, 10.0)
    init = Pose(t=torch.from_numpy(gt[0][0]).to(dev), q=torch.from_numpy(gt[1][0]).to(dev))
    res = runner.run_slam(stream, cfg, init, dev)
    s = {**res.summary(), **runner.evaluate(res, gt)}
    counts = {k: s[k] for k in PATH_COUNTS}
    return {"ms_p50": s["step_ms_p50"], "ms_p90": s["step_ms_p90"], "ate_m": s["ate_m"],
            "counts": counts}


def child(save: str) -> None:
    """One run, in the checkout that is the working directory; the kernel
    outputs go to ``save`` (``torch.save``)."""
    sys.path.insert(0, os.getcwd())
    import torch

    import icpslam_tpu_torch
    from icpslam_tpu_torch.config import kitti_config
    from icpslam_tpu_torch.ops import cuda_build, nn
    from icpslam_tpu_torch.ops import radius_stats as rs

    root = os.path.dirname(os.path.dirname(os.path.realpath(icpslam_tpu_torch.__file__)))
    if root != os.path.realpath(os.getcwd()):
        raise AssertionError(f"imported {icpslam_tpu_torch.__file__}, not the checkout in {os.getcwd()}")
    cs = _smoke()
    dev = torch.device("cuda", 0)
    cuda_build.load()
    clouds, query_world, map_pts, fill = cs._main_path_clouds(dev)
    q, t = clouds[1], clouds[0]
    map_mask = torch.arange(map_pts.shape[0], device=dev) < fill
    vl_map = torch.tensor(fill, dtype=torch.int32, device=dev)
    vl_scan = t.mask.sum(dtype=torch.int32)
    pts, mask = t.points.contiguous(), t.mask
    cases = {
        "K1 scan": (nn.nn1_cuda, (q.points, t.points, t.mask, vl_scan)),
        "K1 map": (nn.nn1_cuda, (query_world.points, map_pts, map_mask, vl_map)),
        "K2 k=10": (nn.knn_cuda, (pts, pts, mask, 10)),
        "K3 taper": (rs.radius_moments_cuda, (pts, pts, mask, 1.0, 0.5)),
        "K3 hard": (rs.radius_moments_cuda, (pts, pts, mask, 1.0, 0.0)),
        "K4 scan": (nn.nn1_matmul_cuda, (q.points, t.points, t.mask, vl_scan)),
        "K4 map": (nn.nn1_matmul_cuda, (query_world.points, map_pts, map_mask, vl_map)),
    }
    kernels, outputs = {}, {}
    for name, (fn, args) in cases.items():
        out = fn(*args)
        tensors = tuple(out)
        kernels[name] = {"ms": cs._device_ms(lambda: fn(*args)),
                         "event_ms": cs._timed(lambda: fn(*args)), "digest": _digest(*tensors)}
        outputs[name] = [x.cpu() for x in tensors]
        if name.startswith("K4"):
            # what the tolerance needs: |q_c|², and |t_c|² and the exact
            # subtraction-form d² of the pick
            qq, tt = args[0], args[1]
            c = qq.mean(0)
            qc, tc = qq - c, tt - c
            pick = tc[out.idx]
            outputs[name] += [nn._sqdist(qc).cpu(), nn._sqdist(pick).cpu(),
                              nn._sqdist(pick - qc).cpu()]
    torch.save(outputs, save)
    result = {"kernels": kernels,
              "slice": _path(kitti_config(), SLICE_SCANS, dev),
              "mission": _path(cs.radius_config(), MISSION_SCANS, dev)}
    print("RESULT " + json.dumps(result))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?", help="another checkout, inside this one")
    ap.add_argument("--child", metavar="SAVE", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.child)
        return 0
    if args.other is None:
        ap.error("OTHER is required")
    other = os.path.realpath(args.other)
    if other == HERE or os.path.commonpath([HERE, other]) != HERE:
        print(f"chip_ab: {other} is not a directory inside {HERE}", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(other, "icpslam_tpu_torch")):
        print(f"chip_ab: no icpslam_tpu_torch in {other}", file=sys.stderr)
        return 2
    runs = {"other": [], "this": []}
    tmp = tempfile.TemporaryDirectory(prefix=".chip_ab_", dir=HERE)
    saved = {"other": [], "this": []}
    for tree in (other, HERE, HERE, other):
        name = "this" if tree == HERE else "other"
        save = os.path.join(tmp.name, f"{name}{len(saved[name])}.pt")
        saved[name].append(save)
        proc = subprocess.run([sys.executable, os.path.join(HERE, "chip_ab.py"), "--child", save],
                              cwd=tree, capture_output=True, text=True, timeout=1200)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            print(f"chip_ab: the run in {tree} failed", file=sys.stderr)
            return 1
        r = json.loads(lines[-1][len("RESULT "):])
        runs[name].append(r)
        ks = "; ".join(f"{k} {v['ms']:.4f} ms (events {v['event_ms']:.4f} ms)"
                       for k, v in r["kernels"].items())
        print(f"{name}: {ks}; slice {r['slice']['ms_p50']:.2f} / {r['slice']['ms_p90']:.2f} ms, "
              f"mission {r['mission']['ms_p50']:.2f} / {r['mission']['ms_p90']:.2f} ms (median / "
              f"p90 per scan); ATE {r['slice']['ate_m']:.4f} / {r['mission']['ate_m']:.4f} m",
              flush=True)
    same = {k: runs["this"][0]["kernels"][k]["digest"] == runs["other"][0]["kernels"][k]["digest"]
            for k in runs["this"][0]["kernels"]}
    repeatable = {name: all(r["kernels"][k]["digest"] == runs[name][0]["kernels"][k]["digest"]
                            for r in runs[name] for k in r["kernels"])
                  for name in runs}
    compared = _compare(saved["this"][0], saved["other"][0])
    same_counts = {p: all(r[p]["counts"] == runs["other"][0][p]["counts"]
                          for rs in runs.values() for r in rs)
                   for p in ("slice", "mission")}
    print(f"path counts {runs['this'][0]['slice']['counts']} (slice), "
          f"{runs['this'][0]['mission']['counts']} (mission); the same in every run: {same_counts}")
    tmp.cleanup()
    ok = all(same[k] for k in same if k.startswith(("K1", "K2"))) and all(
        c["ok"] for c in compared.values())
    print(json.dumps({"runs": runs, "same_kernel_outputs": same,
                      "repeatable_within_checkout": repeatable, "compared": compared,
                      "same_path_counts": same_counts, "ok": ok}))
    return 0 if ok else 1


def _compare(this: str, other: str) -> dict:
    """K3 and K4 outputs of this checkout against the other's, each under
    its tolerance (see the module docstring)."""
    import torch

    cs = _smoke()
    a, b = torch.load(this), torch.load(other)
    out = {}
    for name in ("K3 taper", "K3 hard"):
        ok, worst = True, 0.0
        for x, y in zip(a[name], b[name]):
            diff = (x - y).abs()
            ok &= bool((diff <= cs.MOM_ABS + cs.MOM_REL * y.abs()).all())
            worst = max(worst, float(diff.max()))
        if name == "K3 hard":
            ok &= torch.equal(a[name][0], b[name][0])
        out[name] = {"ok": ok, "max_abs_diff": worst}
    for name in ("K4 scan", "K4 map"):
        (ia, da, qc2, ta, sa), (ib, db, _, tb, sb) = a[name], b[name]
        tol = cs.K4_REL * (qc2 + torch.maximum(ta, tb)) + cs.K4_ABS
        fin = torch.isfinite(db)
        differ = (ia != ib) & fin
        ok = (torch.equal(fin, torch.isfinite(da)) and bool(((da - db).abs() <= tol)[fin].all())
              and bool(((sa - sb).abs() <= tol)[differ].all()))
        out[name] = {"ok": ok, "max_abs_diff": float((da - db).abs()[fin].max()),
                     "picks_differ": int(differ.sum())}
    return out


if __name__ == "__main__":
    sys.exit(main())
