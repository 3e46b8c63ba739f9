"""The port's frames, exports and viewer against the JAX package's.

One port run of a small room loop that closes (12 scans, loop edges and
graph solves) gives the state; the JAX writers get the same state as
numpy arrays, so both packages write the same inputs and the files are
compared byte for byte (PLY, TUM, pose-graph JSON) or by their decoded
layers (the HTML viewer).
"""

import torch

# one intra-op thread per test worker: the suite runs several pytest
# workers on the host's cores beside XLA's own pool
torch.set_num_threads(1)

import base64
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest

from icpslam_tpu import config as jconfig
from icpslam_tpu.cloud import pointcloud as jpc
from icpslam_tpu.geometry import quaternion as jquat
from icpslam_tpu.geometry.se3 import Pose as JPose
from icpslam_tpu.mapping import point_map as jpm
from icpslam_tpu.utils import checkpoint as jckpt
from icpslam_tpu.utils import frames as jframes
from icpslam_tpu.viz import export as jexport
from icpslam_tpu.viz import html as jhtml
from icpslam_tpu_torch import config as tconfig
from icpslam_tpu_torch.cloud import pointcloud as tpc
from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.io import synthetic as tsyn
from icpslam_tpu_torch.pipeline import slam as tslam
from icpslam_tpu_torch.utils import checkpoint as tckpt
from icpslam_tpu_torch.utils import frames as tframes
from icpslam_tpu_torch.utils import interop
from icpslam_tpu_torch.viz import export as texport
from icpslam_tpu_torch.viz import html as thtml

CFG = dict(voxel_leaf_size=0.3, map_resolution=0.3, max_points=512, max_raw_points=1024,
           max_map_points=8192, max_keyframes=32, max_edges=128, keyframe_distance=0.3,
           keyframes_window=4, loop_closure_radius=3.0, loop_closure_min_id_gap=3)
STYLED = dict(marker_scale_nodes=0.2, marker_scale_edges=0.15,
              icp_nodes_markers_color=(1.0, 0.0, 1.0, 1.0),
              odom_nodes_markers_color=(1.0, 0.5, 0.0, 1.0),
              edges_markers_color=(0.1, 0.9, 0.1, 1.0))


@pytest.fixture(scope="module")
def run():
    kw = dict(icp_odometry=tconfig.IcpConfig(mode="plane", max_iterations=10),
              icp_mapping=tconfig.IcpConfig(mode="point", max_iterations=20), **CFG)
    cfg = tconfig.tiny_config(**kw)
    world = tsyn.make_room_world(0, 12000)
    gt = tsyn.make_loop_trajectory(n_poses=12, radius=3.0, laps=1.25)
    state = tslam.init_state(cfg, Pose(torch.from_numpy(gt[0][0]), torch.from_numpy(gt[1][0])),
                             device="cpu")
    traj = []
    for pts, mask in tsyn.scan_stream(world, gt, capacity=cfg.max_raw_points, max_range=12.0,
                                      n_points=1000, noise=0.01, seed=1):
        state, out = tslam.slam_step(state, tpc.PointCloud(torch.from_numpy(pts),
                                                           torch.from_numpy(mask)), cfg)
        traj.append(out.packed)
    rec = torch.stack(traj)
    before = interop.state_to_numpy(state)
    # the last solve reset the map: the full map product is re-rendered
    # from the keyframes, as a resumed run does
    state = tckpt.rerender_map(state, cfg)
    assert int(state.num_loop_closures) >= 1 and int(state.map.size) > 0
    np_state = interop.state_to_numpy(state)
    # JAX's writers read the map through its own PointMap (``as_cloud``)
    jax_state = np_state._replace(map=jpm.PointMap(*np_state.map))
    return {"state": state, "jax_state": jax_state, "traj": Pose(rec[:, :3], rec[:, 3:7]),
            "gt": gt, "before": before, "cfg": kw}


def test_rerender_map_equals_jax(run):
    """The map re-rendered from the keyframes at their graph poses: the
    same points as JAX's, within float32 rounding of the transforms."""
    cfg = jconfig.tiny_config(icp_odometry=jconfig.IcpConfig(mode="plane", max_iterations=10),
                              icp_mapping=jconfig.IcpConfig(mode="point", max_iterations=20), **CFG)
    # the first 3 keyframes (JAX's re-render runs op by op)
    before = run["before"]
    before = before._replace(keyframes=before.keyframes._replace(count=np.int32(3)))
    ref = jckpt.rerender_map(before._replace(map=jpm.PointMap(*before.map)), cfg).map
    got = tckpt.rerender_map(interop.state_from_numpy(before, device="cpu"),
                             tconfig.tiny_config(**run["cfg"])).map
    n = int(ref.size)
    assert int(got.size) == n > 0 and int(got.overflow) == int(ref.overflow)
    # ~10 m from the origin a float32 ulp is 1e-6 m; the two packages
    # round the rotation's terms in another order
    np.testing.assert_allclose(got.points[:n].numpy(), np.asarray(ref.points)[:n], rtol=0, atol=5e-5)


def _jpose(p: Pose) -> JPose:
    return JPose(t=p.t.numpy(), q=p.q.numpy())


# ---- frames -------------------------------------------------------------------

def _rpy_pose(x, y, z, yaw):
    q = np.array(jquat.from_rpy(0.1 * yaw, -0.2 * yaw, yaw), np.float32)
    t = np.array([x, y, z], np.float32)
    return Pose(torch.from_numpy(t), torch.from_numpy(q)), JPose(t=jnp.asarray(t), q=jnp.asarray(q))


def test_frame_graph_lookups_equal_jax():
    tg, jg = tframes.FrameGraph(), jframes.FrameGraph()
    edges = [("map", "odom", (1.0, 0.0, 0.0, 0.3)), ("odom", "base", (0.0, 2.0, 0.5, -1.1)),
             ("base", "laser", (0.2, 0.0, 1.7, 2.9)), ("map", "gps", (5.0, -3.0, 0.0, 0.7))]
    for parent, child, spec in edges:
        tp, jp = _rpy_pose(*spec)
        tg.set_transform(parent, child, tp)
        jg.set_transform(parent, child, jp)
    assert tg.frames() == jg.frames()
    names = tg.frames()
    for a in names:
        for b in names:
            tp, jp = tg.lookup(a, b), jg.lookup(a, b)
            np.testing.assert_allclose(tp.t.numpy(), np.asarray(jp.t), rtol=0, atol=1e-5)
            np.testing.assert_allclose(tp.q.numpy(), np.asarray(jp.q), rtol=0, atol=1e-6)
    tg.set_transform("other", "thing", _rpy_pose(0, 0, 0, 0)[0])
    with pytest.raises(KeyError):
        tg.lookup("odom", "thing")
    with pytest.raises(ValueError):
        tg.set_transform("laser", "map", _rpy_pose(0, 0, 0, 0)[0])
    with pytest.raises(ValueError):
        tg.set_transform("gps", "odom", _rpy_pose(0, 0, 0, 0)[0])


def test_default_frame_graph_equals_jax():
    tp, jp = _rpy_pose(0.3, 0.0, 1.2, 0.4)
    t = tframes.default_frame_graph(tconfig.tiny_config(), tp)
    j = jframes.default_frame_graph(jconfig.tiny_config(), jp)
    assert t.frames() == j.frames() == ["base_link", "laser", "map", "odom"]
    got, ref = t.lookup("map", "laser"), j.lookup("map", "laser")
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-6)
    np.testing.assert_allclose(got.q.numpy(), np.asarray(ref.q), atol=1e-6)


# ---- exports ------------------------------------------------------------------

@pytest.mark.parametrize("colored", [False, True], ids=["xyz", "rgb"])
def test_save_ply_bytes_equal_jax(tmp_path, colored):
    rng = np.random.RandomState(0)
    pts = rng.randn(64, 3).astype(np.float32)
    mask = rng.rand(64) > 0.3
    colors = rng.randint(0, 256, (int(mask.sum()), 3)) if colored else None
    n = texport.save_ply(str(tmp_path / "t.ply"),
                         tpc.PointCloud(torch.from_numpy(pts), torch.from_numpy(mask)), colors)
    m = jexport.save_ply(str(tmp_path / "j.ply"), jpc.PointCloud(points=pts, mask=mask), colors)
    assert n == m == int(mask.sum())
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_map_ply_equals_jax(run, tmp_path):
    pmap = run["state"].map
    cloud = tpc.PointCloud(pmap.points, torch.arange(pmap.capacity) < pmap.size)
    texport.save_ply(str(tmp_path / "t.ply"), cloud)
    jexport.save_ply(str(tmp_path / "j.ply"), run["jax_state"].map.as_cloud())
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_tum_trajectory_equals_jax(run, tmp_path):
    traj = run["traj"]
    stamps = 1.0e9 + 0.1 * np.arange(traj.t.shape[0])
    for name, st in (("counter", None), ("stamped", stamps)):
        n = texport.export_trajectory_tum(str(tmp_path / f"t_{name}.txt"), traj, st)
        m = jexport.export_trajectory_tum(str(tmp_path / f"j_{name}.txt"), _jpose(traj), st)
        assert n == m == 12
        assert (tmp_path / f"t_{name}.txt").read_text() == (tmp_path / f"j_{name}.txt").read_text()


def test_pose_graph_json_equals_jax(run, tmp_path):
    doc = texport.export_pose_graph_json(str(tmp_path / "t.json"), run["state"])
    ref = jexport.export_pose_graph_json(str(tmp_path / "j.json"), run["jax_state"])
    assert doc == ref
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    assert any(e["type"] == "loop" for e in doc["edges"])


# ---- the viewer ---------------------------------------------------------------

def _decoded(path):
    text = path.read_text()
    doc = json.loads(re.search(r"const DATA = (.*?);\n", text).group(1))
    for layer in doc["layers"]:
        for key in ("pos", "colors"):
            if key in layer:
                layer[key] = np.frombuffer(base64.b64decode(layer[key]), "<f4").reshape(-1, 3)
    return doc, text


@pytest.mark.parametrize("styled", [False, True], ids=["default", "styled"])
def test_export_state_html_layers_equal_jax(run, tmp_path, styled):
    tcfg = tconfig.tiny_config(**STYLED) if styled else tconfig.tiny_config()
    jcfg = jconfig.tiny_config(**STYLED) if styled else jconfig.tiny_config()
    traj, (gt_t, gt_q) = run["traj"], run["gt"]
    thtml.export_state_html(str(tmp_path / "t.html"), run["state"], trajectory=traj,
                            ground_truth=Pose(torch.from_numpy(gt_t), torch.from_numpy(gt_q)),
                            title="run", config=tcfg, max_map_points=500)
    jhtml.export_state_html(str(tmp_path / "j.html"), run["jax_state"], trajectory=_jpose(traj),
                            ground_truth=JPose(t=gt_t, q=gt_q), title="run", config=jcfg,
                            max_map_points=500)
    (doc, text), (ref, ref_text) = _decoded(tmp_path / "t.html"), _decoded(tmp_path / "j.html")
    assert doc["title"] == ref["title"] and doc["stats"] == ref["stats"]
    assert [ly["name"] for ly in doc["layers"]] == [ly["name"] for ly in ref["layers"]]
    for mine, want in zip(doc["layers"], ref["layers"]):
        assert set(mine) == set(want), mine["name"]
        for key, value in want.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(mine[key], value, err_msg=f"{want['name']}.{key}")
            else:
                assert mine[key] == value, (want["name"], key)
    names = {ly["name"] for ly in doc["layers"]}
    assert {"map", "trajectory", "ground truth", "graph nodes", "loop edges"} <= names
    assert ("odom nodes" in names) == styled
    # the same page around the data
    strip = lambda t: re.sub(r"const DATA = .*?;\n", "", t)  # noqa: E731
    assert strip(text) == strip(ref_text)
    assert "http://" not in text and "https://" not in text
