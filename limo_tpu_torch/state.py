"""Window state — fixed-shape tensors with validity masks.

The reference keeps ``std::map<KeyframeId, Keyframe>`` +
``std::map<LandmarkId, Landmark>`` + per-keyframe measurement maps
(``keyframe.hpp:171-196``, ``bundle_adjuster_keyframes.hpp:216-260``) and
rebuilds a ceres::Problem every solve. The port keeps one struct of tensors
with static capacities and validity masks, as the reference package does;
every "scheme" produces masks/weights, and the solver consumes the struct
directly.

Layout is landmark-major (``obs[L,K,C,3]``).

The ``*_from_numpy`` functions carry state across from the reference
package: they take its ``Window``/``Selection``/``CameraRig`` as numpy
arrays (any object with the same field names) and a ``LimoConfig`` given as
``dataclasses.asdict``, so that both packages can be fed identical state.
The host engine's state (``BundleAdjuster``, the odometry drivers,
``FeatureTracker``) is numpy mirrors and Python bookkeeping on both sides,
copied across attribute by attribute.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .config import CapacityConfig, LimoConfig
from .geometry.camera import CameraRig


class Window(NamedTuple):
    """Sliding optimization window. K keyframe slots, L landmark slots,
    C cameras. All tensors fixed-shape; masks define validity.

    Poses are keyframe ← origin (world-to-body), 7-vectors (quat wxyz, t xyz).
    Planes are local groundplanes per keyframe: (nx, ny, nz, d) with
    n·p + d = 0 for points p on the plane in keyframe coordinates
    (``definitions.hpp:27-34``); ``plane_valid`` False reproduces the
    reference's ``distance = -max ⇒ disabled`` convention.
    Observations are (u, v, d) with d < 0 ⇒ no measured depth
    (``matches_msg_types/feature_point.hpp``).
    """

    # keyframes --------------------------------------------------------
    stamps: torch.Tensor        # [K] seconds (f64 in an f64 window, else f32)
    poses: torch.Tensor         # [K,7]
    kf_valid: torch.Tensor      # [K] bool — slot holds an active keyframe
    fix_pose: torch.Tensor      # [K] bool — FixationStatus::Pose
    fix_scale: torch.Tensor     # [K] bool — FixationStatus::Scale
    planes: torch.Tensor        # [K,4]
    plane_valid: torch.Tensor   # [K] bool
    # landmarks --------------------------------------------------------
    lm_pos: torch.Tensor        # [L,3] in origin frame
    lm_valid: torch.Tensor      # [L] bool
    lm_weight: torch.Tensor     # [L] label-derived weight (shrubbery 0.9 ...)
    lm_has_depth: torch.Tensor  # [L] bool
    lm_is_gp: torch.Tensor      # [L] bool
    lm_id: torch.Tensor         # [L] int32 global track id (-1 = empty slot)
    # observations -----------------------------------------------------
    obs: torch.Tensor           # [L,K,C,3] (u,v,d)
    obs_mask: torch.Tensor      # [L,K,C] bool

    @property
    def K(self) -> int:
        return self.poses.shape[0]

    @property
    def L(self) -> int:
        return self.lm_pos.shape[0]

    @property
    def C(self) -> int:
        return self.obs.shape[2]


def empty_window(cap: CapacityConfig, dtype=torch.float32,
                 device="cuda") -> Window:
    K, L, C = cap.max_keyframes, cap.max_landmarks, cap.max_cameras
    kw = dict(dtype=dtype, device=device)
    pose0 = torch.zeros((K, 7), **kw)
    pose0[:, 0] = 1.0
    plane0 = torch.zeros((K, 4), **kw)
    plane0[:, 2] = 1.0
    flags = lambda n: torch.zeros((n,), dtype=torch.bool, device=device)
    stamp_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    return Window(
        stamps=torch.zeros((K,), dtype=stamp_dtype, device=device),
        poses=pose0,
        kf_valid=flags(K),
        fix_pose=flags(K),
        fix_scale=flags(K),
        planes=plane0,
        plane_valid=flags(K),
        lm_pos=torch.zeros((L, 3), **kw),
        lm_valid=flags(L),
        lm_weight=torch.ones((L,), **kw),
        lm_has_depth=flags(L),
        lm_is_gp=flags(L),
        lm_id=torch.full((L,), -1, dtype=torch.int32, device=device),
        obs=torch.zeros((L, K, C, 3), **kw),
        obs_mask=torch.zeros((L, K, C), dtype=torch.bool, device=device),
    )


class Selection(NamedTuple):
    """Output of the landmark selector + solve-time wiring, consumed by the
    BA solver. Replaces the reference's selected_landmark_ids_ +
    addGroundPlaneResiduals / addScaleRegularization bookkeeping."""

    lm_selected: torch.Tensor   # [L] bool — participate in this solve
    gp_kf: torch.Tensor         # [L] int32 — keyframe owning this gp landmark's
                                # height residual (nearest active kf w/ plane)
    gp_weight: torch.Tensor     # [L] weight*(1 - d/25); 0 ⇒ no gp residual
    # scale regularization (two oldest active keyframes)
    scale_kf0: torch.Tensor     # int32
    scale_kf1: torch.Tensor     # int32
    scale_target: torch.Tensor  # current ‖t1−t0‖ to pin
    scale_weight: torch.Tensor  # 0 ⇒ disabled
    plane_dist_fixed: torch.Tensor  # bool — fix plane distances (few depth res)


def _tensors_from(cls, src, device):
    return cls(*[torch.as_tensor(np.array(getattr(src, f)), device=device)
                 for f in cls._fields])


def window_from_numpy(w, device="cuda") -> Window:
    """Window from the reference package's Window (numpy or array-likes)."""
    return _tensors_from(Window, w, device)


def selection_from_numpy(sel, device="cuda") -> Selection:
    """Selection from the reference package's Selection."""
    return _tensors_from(Selection, sel, device)


def rig_from_numpy(rig, device="cuda") -> CameraRig:
    """CameraRig from the reference package's CameraRig."""
    return _tensors_from(CameraRig, rig, device)


def window_to_numpy(w: Window) -> Window:
    """Device → host copy: a Window of numpy arrays."""
    return Window(*[x.detach().cpu().numpy() for x in w])


def scan_state_from_numpy(st, device="cuda"):
    """ScanState from the reference package's ScanState (numpy or
    array-likes), window included."""
    from .pipeline.scan_odometry import ScanState
    return ScanState(window=window_from_numpy(st.window, device),
                     **{f: torch.as_tensor(np.array(getattr(st, f)),
                                           device=device)
                        for f in ScanState._fields[1:]})


def scan_state_to_numpy(st):
    """Device → host copy: a ScanState of numpy arrays."""
    return type(st)(window_to_numpy(st.window),
                    *[x.detach().cpu().numpy() for x in st[1:]])


def fused_state_from_numpy(st, device="cuda"):
    """FusedState from the reference package's FusedState (numpy or
    array-likes), scan state included."""
    from .pipeline.fused import FusedState
    return FusedState(scan=scan_state_from_numpy(st.scan, device),
                      **{f: torch.as_tensor(np.array(getattr(st, f)),
                                            device=device)
                         for f in FusedState._fields[1:]})


def fused_state_to_numpy(st):
    """Device → host copy: a FusedState of numpy arrays."""
    return type(st)(scan_state_to_numpy(st.scan),
                    *[x.detach().cpu().numpy() for x in st[1:]])


def config_from_dict(d: dict) -> LimoConfig:
    """LimoConfig from ``dataclasses.asdict`` of the reference's config
    (field names are shared; lists become the tuples the dataclasses hold)."""
    default = LimoConfig()
    groups = {}
    for f in dataclasses.fields(LimoConfig):
        kv = {k: tuple(v) if isinstance(v, list) else v
              for k, v in d[f.name].items()}
        groups[f.name] = type(getattr(default, f.name))(**kv)
    return LimoConfig(**groups)


# the host state of a BundleAdjuster: numpy mirrors of the Window, the slot
# allocator's bookkeeping, the archive and the last selection
BUNDLE_ADJUSTER_STATE = (
    "_stamps", "_poses", "_kf_valid", "_fixation", "_planes", "_plane_valid",
    "_lm_pos", "_lm_valid", "_lm_weight", "_lm_has_depth", "_lm_is_gp",
    "_lm_id", "_lm_known", "_lm_outlier", "_obs", "_obs_mask", "_kf_order",
    "_lm_slot", "_archive", "_last_selection", "_last_categories",
    "_unselected_counts", "_unselected_last_seen")
ODOMETRY_STATE = ("_last_solve_stamp", "_last_frame_stamp")


def _torch_dtype(dtype):
    return torch.float64 if np.dtype(dtype) == np.float64 else torch.float32


def bundle_adjuster_from_numpy(ba, device="cuda"):
    """The port's BundleAdjuster holding the reference package's
    BundleAdjuster's host state (a deep copy), rig, config and float type."""
    from .window_manager import BundleAdjuster
    out = BundleAdjuster(rig_from_numpy(ba.rig, device),
                         config_from_dict(dataclasses.asdict(ba.cfg)),
                         _torch_dtype(ba.dtype), device)
    for k in BUNDLE_ADJUSTER_STATE:
        setattr(out, k, copy.deepcopy(getattr(ba, k)))
    return out


def odometry_from_numpy(odo, device="cuda"):
    """The port's MonoOdometry or LidarOdometry (the reference's class name)
    holding the reference package's driver's host state: its adjuster
    (:func:`bundle_adjuster_from_numpy`), trajectory and stamps."""
    from .pipeline import odometry
    adjuster = bundle_adjuster_from_numpy(odo.adjuster, device)
    out = getattr(odometry, type(odo).__name__)(
        adjuster.rig, adjuster.cfg, adjuster.dtype, device)
    out.adjuster = adjuster
    out.trajectory = [odometry.FrameResult(r.stamp, np.array(r.pose),
                                           r.is_keyframe, r.solved)
                      for r in odo.trajectory]
    for k in ODOMETRY_STATE:
        setattr(out, k, getattr(odo, k))
    return out


def feature_tracker_from_numpy(tr, device="cuda", dtype=torch.float32):
    """The port's FeatureTracker holding the reference package's tracker's
    state: its TrackletBuilder's fields (deep copies) and the previous
    frame's features."""
    from .frontend.tracker import FeatureTracker, Features, TrackerConfig
    from .pipeline.tracklets import TrackletBuilder
    out = FeatureTracker(TrackerConfig(**dataclasses.asdict(tr.cfg)),
                         tr.builder.max_track_length, device, dtype)
    out.builder = TrackletBuilder.__new__(TrackletBuilder)
    out.builder.__dict__.update(copy.deepcopy(vars(tr.builder)))
    if tr._prev is not None:
        out._prev = Features(*[torch.as_tensor(np.array(x), device=device)
                               for x in tr._prev])
        out._prev_valid_np = np.array(tr._prev_valid_np)
    return out

