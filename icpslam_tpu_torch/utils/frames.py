"""Coordinate-frame registry, the tf-tree replacement (port of
``icpslam_tpu/utils/frames.py``).

A tree of named frames with one pose per edge (child in parent), and a
lookup between any two connected frames by composing along the tree: the
map → odom → base_link → laser chain of the reference. Host-side utility
over ``Pose``s of tensors; the step never touches it (the laser extrinsic
is applied to every scan at ingest).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from icpslam_tpu_torch.geometry import se3
from icpslam_tpu_torch.geometry.se3 import Pose


class FrameGraph:
    """Tree of frames: each child has one parent and a parent←child pose."""

    def __init__(self):
        self._parent: Dict[str, Tuple[str, Pose]] = {}

    def set_transform(self, parent: str, child: str, pose: Pose) -> None:
        """Register or update the pose of ``child`` expressed in ``parent``."""
        if child in self._parent and self._parent[child][0] != parent:
            raise ValueError(f"frame '{child}' already attached to '{self._parent[child][0]}'")
        if child != parent and self._is_ancestor(child, parent):
            raise ValueError(f"{parent}->{child} would create a cycle")
        self._parent[child] = (parent, pose)

    def _is_ancestor(self, frame: str, of: str) -> bool:
        cur = of
        while cur in self._parent:
            cur = self._parent[cur][0]
            if cur == frame:
                return True
        return False

    def _path_to_root(self, frame: str) -> List[str]:
        path = [frame]
        while path[-1] in self._parent:
            path.append(self._parent[path[-1]][0])
        return path

    def _pose_to_ancestor(self, frame: str, ancestor: str) -> Pose:
        pose = se3.identity()
        cur = frame
        while cur != ancestor:
            parent, rel = self._parent[cur]
            pose = se3.compose(rel, pose)
            cur = parent
        return pose

    def lookup(self, target: str, source: str) -> Pose:
        """Pose of ``source`` expressed in ``target`` (tf's lookupTransform
        argument order). Raises ``KeyError`` when they are not connected."""
        if target == source:
            return se3.identity()
        tset = set(self._path_to_root(target))
        common: Optional[str] = next((f for f in self._path_to_root(source) if f in tset), None)
        if common is None:
            raise KeyError(f"frames '{target}' and '{source}' are not connected")
        t_in_common = self._pose_to_ancestor(target, common)
        s_in_common = self._pose_to_ancestor(source, common)
        return se3.compose(se3.inverse(t_in_common), s_in_common)

    def frames(self) -> List[str]:
        roots = {p for p, _ in self._parent.values()} - set(self._parent)
        return sorted(set(self._parent) | roots)


def default_frame_graph(config, laser_in_robot: Optional[Pose] = None) -> FrameGraph:
    """The reference's frame chain: map → odom → base → laser."""
    g = FrameGraph()
    g.set_transform(config.map_frame, config.odom_frame, se3.identity())
    g.set_transform(config.odom_frame, config.robot_frame, se3.identity())
    g.set_transform(config.robot_frame, config.laser_frame,
                    laser_in_robot if laser_in_robot is not None else se3.identity())
    return g
