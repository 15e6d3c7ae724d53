"""Static transform tree — the ROS-free replacement for the reference's tf2
usage and its ``StaticTransformAlias`` node
(util_nodes_tf2_ros_tool/src/static_transform_alias/static_transform_alias.cpp:50-90):
the node looks up T(from_target ← from_source) in the tf tree once and
republishes it between two *aliased* frame names, building a parallel
``estimate/...`` tree next to ground truth
(launch/tf2_static_aliases_kitti.launch).

Here the tree is an explicit in-process frame graph of 4×4 homogeneous
transforms. ``lookup`` chains through the graph (both edge directions), and
``alias`` re-registers a looked-up transform under new frame names — the
exact ``do_aliasing`` contract without a ROS broadcaster. A numpy copy of
the reference package's ``limo_tpu/utils/transforms.py``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


class TransformLookupError(KeyError):
    """No path between the requested frames (tf2::LookupException analog)."""


class TransformTree:
    """Graph of static frames; edges are 4×4 transforms T(parent ← child)."""

    def __init__(self):
        self._edges: Dict[Tuple[str, str], np.ndarray] = {}
        self._adj: Dict[str, List[str]] = {}

    def set_transform(self, parent: str, child: str, T: np.ndarray) -> None:
        """Register T(parent ← child): maps points in ``child`` coordinates
        into ``parent`` coordinates."""
        T = np.asarray(T, np.float64)
        if T.shape != (4, 4):
            raise ValueError(f"expected 4x4 transform, got {T.shape}")
        # latest broadcast wins regardless of orientation (tf2 semantics)
        self._edges.pop((child, parent), None)
        self._edges[(parent, child)] = T
        self._adj.setdefault(parent, [])
        self._adj.setdefault(child, [])
        if child not in self._adj[parent]:
            self._adj[parent].append(child)
        if parent not in self._adj[child]:
            self._adj[child].append(parent)

    def _edge(self, a: str, b: str) -> np.ndarray:
        """T(a ← b) along a registered edge, inverting if stored reversed."""
        if (a, b) in self._edges:
            return self._edges[(a, b)]
        # general 4x4 inverse: edges are only shape-checked, so do not
        # assume the rotation block is orthonormal
        return np.linalg.inv(self._edges[(b, a)])

    def lookup(self, target: str, source: str) -> np.ndarray:
        """T(target ← source), chaining through the frame graph (BFS) —
        ``tfBuffer_.lookupTransform(target, source)``."""
        if target == source:
            if target not in self._adj:
                raise TransformLookupError(f"unknown frame {target!r}")
            return np.eye(4)
        if target not in self._adj or source not in self._adj:
            raise TransformLookupError(
                f"unknown frame in lookup({target!r}, {source!r})")
        # BFS from source up/down to target, accumulating parents
        prev: Dict[str, str] = {source: source}
        queue = [source]
        while queue:
            f = queue.pop(0)
            if f == target:
                break
            for g in self._adj[f]:
                if g not in prev:
                    prev[g] = f
                    queue.append(g)
        if target not in prev:
            raise TransformLookupError(f"no path {target!r} <- {source!r}")
        # walk back target→source, composing T(target←source)
        chain: List[str] = [target]
        while chain[-1] != source:
            chain.append(prev[chain[-1]])
        T = np.eye(4)
        for a, b in zip(chain[:-1], chain[1:]):
            T = T @ self._edge(a, b)
        return T

    def alias(self, from_target: str, from_source: str,
              to_target: str, to_source: str) -> np.ndarray:
        """StaticTransformAlias::do_aliasing: look up
        T(from_target ← from_source) once and re-register it as
        T(to_target ← to_source) — used to clone a calibration subtree under
        an ``estimate/`` namespace. Returns the aliased transform."""
        T = self.lookup(from_target, from_source)
        self.set_transform(to_target, to_source, T)
        return T

    def frames(self) -> List[str]:
        return sorted(self._adj)
