"""Tracklets — the SoA wire format between tracker, depth estimator, labeler
and the BA engine.

Reference: ``matches_msg_types`` (tracklets.hpp:10-15, tracklet.hpp:5-12,
feature_point.hpp:4-36): per track a list of (u,v,d) newest-first aligned to
``stamps``, plus (id, age, is_outlier, label). The TPU equivalent is a dense
``[num_tracks, window, 3]`` array + per-track metadata with a validity mask —
the natural struct-of-arrays layout (SURVEY §2.1).

A numpy copy of the reference package's ``limo_tpu/pipeline/tracklets.py``,
so that the port's host engine runs without that package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

NO_DEPTH = -1.0
NO_LABEL = -2  # reference default label (tracklet.hpp)


@dataclass
class Tracklets:
    """Host-side track container (numpy; becomes device arrays at the
    window boundary).

    stamps:   [S] float seconds, newest first (reference convention)
    uvd:      [N, S, 3] (u, v, depth); depth < 0 ⇒ none
    mask:     [N, S] bool — track has a feature at that stamp
    ids:      [N] int64 global track ids
    age:      [N] int32
    is_outlier: [N] bool
    label:    [N] int32 semantic label
    """

    stamps: np.ndarray
    uvd: np.ndarray
    mask: np.ndarray
    ids: np.ndarray
    age: np.ndarray
    is_outlier: np.ndarray
    label: np.ndarray

    @property
    def num_tracks(self) -> int:
        return self.uvd.shape[0]

    @property
    def num_stamps(self) -> int:
        return self.stamps.shape[0]

    @staticmethod
    def empty(window: int = 0) -> "Tracklets":
        return Tracklets(
            stamps=np.zeros((window,)),
            uvd=np.zeros((0, window, 3)),
            mask=np.zeros((0, window), bool),
            ids=np.zeros((0,), np.int64),
            age=np.zeros((0,), np.int32),
            is_outlier=np.zeros((0,), bool),
            label=np.full((0,), NO_LABEL, np.int32),
        )

    def stamp_index(self, stamp: float, atol: float = 1e-6) -> Optional[int]:
        """Index of ``stamp`` in stamps (newest-first), as used by
        ``Keyframe::assignMeasurements`` (keyframe.cpp:61-75)."""
        d = np.abs(self.stamps - stamp)
        i = int(np.argmin(d)) if d.size else None
        return i if i is not None and d[i] <= atol else None

    def measurements_at(self, stamp: float):
        """(ids, uvd, valid-mask) of tracks observed at ``stamp``."""
        i = self.stamp_index(stamp)
        if i is None:
            return (np.zeros((0,), np.int64), np.zeros((0, 3)), np.zeros((0,), bool))
        m = self.mask[:, i]
        return self.ids[m], self.uvd[m, i], m


def merge_tracklets(per_camera: List["Tracklets"],
                    id_stride: int = 1_000_000):
    """Merge per-camera tracklet streams into one stream + a track→camera
    routing map — the reference's multi-camera ingestion, where each track
    is observed by exactly one camera and keyframes route measurements via
    ``landmark_to_cameras`` (keyframe.cpp:43-59).

    Track ids are namespaced per camera (``id + cam * id_stride``) so two
    cameras' trackers can both start at id 0. All streams must share the
    same capture clock (equal newest-first stamp windows; shorter windows
    are aligned on the newest stamps).

    Returns (merged Tracklets, {global_id: camera_index})."""
    assert per_camera, "need at least one camera stream"
    S = max(t.num_stamps for t in per_camera)
    ref = max(per_camera, key=lambda t: t.num_stamps)
    stamps = ref.stamps[:S]
    parts = []
    cam_of: Dict[int, int] = {}
    ref_cam = per_camera.index(ref)
    for c, t in enumerate(per_camera):
        # absolute tolerance: epoch-scale stamps (~1e9 s) make the default
        # rtol=1e-5 vacuous (~1e4 s); 1 µs catches real misalignment
        if t.num_stamps and not np.allclose(t.stamps,
                                            stamps[: t.num_stamps],
                                            rtol=0.0, atol=1e-6):
            raise ValueError(
                f"camera {c} stamps disagree with reference camera "
                f"{ref_cam} (longest stream)")
        uvd = np.zeros((t.num_tracks, S, 3))
        uvd[..., 2] = NO_DEPTH
        uvd[:, : t.num_stamps] = t.uvd
        mask = np.zeros((t.num_tracks, S), bool)
        mask[:, : t.num_stamps] = t.mask
        gids = t.ids + c * id_stride
        if np.any(t.ids >= id_stride):
            raise ValueError(f"camera {c} track ids exceed id_stride")
        cam_of.update({int(g): c for g in gids})
        parts.append(Tracklets(stamps=stamps, uvd=uvd, mask=mask, ids=gids,
                               age=t.age, is_outlier=t.is_outlier,
                               label=t.label))
    merged = Tracklets(
        stamps=stamps,
        uvd=np.concatenate([p.uvd for p in parts]),
        mask=np.concatenate([p.mask for p in parts]),
        ids=np.concatenate([p.ids for p in parts]),
        age=np.concatenate([p.age for p in parts]),
        is_outlier=np.concatenate([p.is_outlier for p in parts]),
        label=np.concatenate([p.label for p in parts]),
    )
    return merged, cam_of


def filter_tracklets(tl: "Tracklets", keep: np.ndarray) -> "Tracklets":
    """Row subset of a tracklet stream (e.g. one camera's tracks)."""
    return Tracklets(stamps=tl.stamps, uvd=tl.uvd[keep], mask=tl.mask[keep],
                     ids=tl.ids[keep], age=tl.age[keep],
                     is_outlier=tl.is_outlier[keep], label=tl.label[keep])


class TrackletBuilder:
    """Maintains live tracks across frames — the adapter that turns per-frame
    matched feature pairs (or a full external track table) into ``Tracklets``.

    Mirrors the external ``feature_tracking`` repo's role (SURVEY §2.12);
    max_track_length follows ``config_feature_matching.yaml`` (100).
    """

    def __init__(self, max_track_length: int = 100):
        self.max_track_length = max_track_length
        self._stamps: List[float] = []  # newest first
        self._tracks: Dict[int, List] = {}  # id -> list[(stamp_idx_from_newest, u, v, d)]
        self._next_id = 0
        self._live: Dict[int, int] = {}  # id -> index of feature in last frame

    def push_frame(self, stamp: float, uv: np.ndarray,
                   prev_match: Optional[np.ndarray] = None,
                   depth: Optional[np.ndarray] = None) -> None:
        """Add a frame of features. ``prev_match[i]`` = index of feature i in
        the previous frame (−1 ⇒ new track)."""
        n = uv.shape[0]
        d = depth if depth is not None else np.full((n,), NO_DEPTH)
        new_live: Dict[int, int] = {}
        prev_index_to_id = {v: k for k, v in self._live.items()}
        self._stamps.insert(0, stamp)
        # bound the stamp window at max_track_length (the native table does
        # the same, limo_native.cpp:112-113) — an unbounded stamp list made
        # keep_window grow with total frames, so dead tracks were NEVER
        # garbage-collected and to_tracklets() grew without bound
        if len(self._stamps) > self.max_track_length:
            del self._stamps[self.max_track_length:]
        for t in self._tracks.values():
            for obs in t:
                obs[0] += 1  # ages of stamp indices shift
        for i in range(n):
            j = int(prev_match[i]) if prev_match is not None else -1
            tid = prev_index_to_id.get(j, -1) if j >= 0 else -1
            if tid < 0:
                tid = self._next_id
                self._next_id += 1
                self._tracks[tid] = []
            track = self._tracks[tid]
            track.insert(0, [0, float(uv[i, 0]), float(uv[i, 1]), float(d[i])])
            if len(track) > self.max_track_length:
                track.pop()
            new_live[tid] = i
        # drop tracks that ended
        dead = [tid for tid in self._tracks if tid not in new_live
                and self._tracks[tid][0][0] > 0]
        keep_window = len(self._stamps)
        for tid in dead:
            if self._tracks[tid][0][0] >= keep_window:
                del self._tracks[tid]
        self._live = new_live

    def to_tracklets(self, window: Optional[int] = None) -> Tracklets:
        S = len(self._stamps) if window is None else min(window, len(self._stamps))
        ids = np.array(sorted(self._tracks.keys()), np.int64)
        N = ids.shape[0]
        uvd = np.zeros((N, S, 3))
        uvd[..., 2] = NO_DEPTH
        mask = np.zeros((N, S), bool)
        age = np.zeros((N,), np.int32)
        for r, tid in enumerate(ids):
            for si, u, v, d in self._tracks[tid]:
                if si < S:
                    uvd[r, si] = (u, v, d)
                    mask[r, si] = True
            age[r] = len(self._tracks[tid])
        return Tracklets(
            stamps=np.array(self._stamps[:S]),
            uvd=uvd, mask=mask, ids=ids, age=age,
            is_outlier=np.zeros((N,), bool),
            label=np.full((N,), NO_LABEL, np.int32),
        )
