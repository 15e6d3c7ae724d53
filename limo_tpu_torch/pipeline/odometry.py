"""Online odometry drivers — the per-frame equivalents of the reference ROS
nodes.

The reference package's ``limo_tpu/pipeline/odometry.py``.
``MonoOdometry`` mirrors ``MonoStandalone`` (mono_standalone.cpp:78-273):
tracklets in → 5-point motion prior → motion-only adjustment → keyframe
selection → push → throttled windowed solve → trajectory out.
``LidarOdometry`` mirrors ``MonoLidar`` (mono_lidar.cpp:88-373): the same
skeleton with lidar depths on the tracklets and the groundplane scale
machinery.

The host loop shuffles small arrays and decides keyframing; the prior, the
motion-only solve, the keyframe gates, the selection and the windowed BA
run on the device (plain functions, each with one upload of its inputs and
one read of its results).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..config import LimoConfig
from ..frontend.essential import estimate_essential, motion_prior_unscaled
from ..geometry import pose as pose_ops
from ..geometry import pose_host as ph
from ..selection.keyframe import select_keyframe
from ..utils.diagnostics import (DiagnosticUpdater, FrequencyStatus,
                                 SensorStatusCheck)
from ..utils.profiling import traced
from ..utils.transfer import numpy_float, read_back, upload
from ..window_manager import FIX_NONE, FIX_POSE, FIX_SCALE, BundleAdjuster
from .tracklets import Tracklets


@dataclass
class FrameResult:
    stamp: float
    pose: np.ndarray              # keyframe←origin (7)
    is_keyframe: bool
    solved: bool


class MonoOdometry:
    """Monocular odometry: scale from the prior/scale-regularization only
    (groundplane variant in LidarOdometry). ``device``: where the numeric
    steps run (the card unless the caller asks for the CPU)."""

    def __init__(self, rig, cfg: Optional[LimoConfig] = None,
                 dtype=torch.float32, device="cuda"):
        self.cfg = cfg or LimoConfig()
        self.rig = rig
        self.dtype = dtype
        self.device = torch.device(device)
        self.adjuster = BundleAdjuster(rig, self.cfg, dtype, device)
        self.trajectory: List[FrameResult] = []
        self._last_solve_stamp: Optional[float] = None
        self._last_frame_stamp: Optional[float] = None
        # diagnostics heartbeat (mono_lidar.cpp:490-507): sensor status +
        # frame-rate watch, updated once per frame (throttled to 1 Hz wall)
        self.sensor_status = SensorStatusCheck()
        self.frame_rate = FrequencyStatus(
            min_freq=1.0 / max(
                self.cfg.keyframe_selection.time_between_keyframes_sec, 1e-3),
            max_freq=None, tolerance=0.5)
        self.diagnostics = DiagnosticUpdater(
            hardware_id=type(self).__name__)
        self.diagnostics.add("Sensor Status", self.sensor_status)
        self.diagnostics.add("Frame Rate", self.frame_rate)
        self.diagnostics.force_update()

    # ------------------------------------------------------------------

    def _matches(self, tracklets: Tracklets, stamp_a: float, stamp_b: float):
        """Matched (uv_a, uv_b, mask) between two stamps, excluding outlier
        labels (``getMatches``, general_helpers.hpp:44-76)."""
        ia = tracklets.stamp_index(stamp_a)
        ib = tracklets.stamp_index(stamp_b)
        if ia is None or ib is None:
            return None
        m = tracklets.mask[:, ia] & tracklets.mask[:, ib] & ~tracklets.is_outlier
        return tracklets.uvd[:, ia, :2], tracklets.uvd[:, ib, :2], m

    def _speed_estimate(self) -> float:
        """Speed from the last two keyframes (mono prior default 13 m/s,
        general_helpers.hpp:215 / mono_lidar.cpp:168-185)."""
        kfs = self.adjuster.keyframe_poses()
        if len(kfs) < 2:
            return self.cfg.prior.default_speed
        (t0, p0), (t1, p1) = kfs[-2], kfs[-1]
        if t1 <= t0:
            return self.cfg.prior.default_speed
        d = ph.relative(p1, p0)
        return float(np.linalg.norm(d[4:]) / (t1 - t0))

    def _padded_matches(self, tracklets: Tracklets, stamp_a: float,
                        stamp_b: float):
        """_matches padded/truncated to landmark capacity: fixed shapes for
        the device steps, matched rows first (a head-truncate would keep
        the lowest track ids — mostly dead tracks on long sequences)."""
        m = self._matches(tracklets, stamp_a, stamp_b)
        if m is None:
            return None
        uv_a, uv_b, mask = m
        N = self.cfg.capacity.max_landmarks
        idx = np.flatnonzero(mask)[:N]
        out_a = np.zeros((N, 2), uv_a.dtype)
        out_b = np.zeros((N, 2), uv_b.dtype)
        out_m = np.zeros((N,), bool)
        out_a[:idx.size] = uv_a[idx]
        out_b[:idx.size] = uv_b[idx]
        out_m[:idx.size] = True
        return out_a, out_b, out_m

    @traced("limo.essential")
    def _motion_prior(self, tracklets: Tracklets, stamp: float) -> np.ndarray:
        """5-point prior: essential matrix between the current frame and the
        last keyframe, translation scaled by speed·Δt, composed with the
        last keyframe's pose; one upload and one read."""
        kfs = self.adjuster.keyframe_poses()
        last_stamp, last_pose = kfs[-1]
        m = self._padded_matches(tracklets, stamp, last_stamp)
        if m is None or int(m[2].sum()) < 8:
            return last_pose  # no matches: assume no motion
        uv_new, uv_old, mask = m
        dt = max(stamp - last_stamp, 1e-3)
        np_dt = numpy_float(self.dtype)
        uv0, uv1, mask_t, speed, dt_t, last = upload(
            [np.asarray(uv_old, np_dt), np.asarray(uv_new, np_dt), mask,
             np.asarray(self._speed_estimate(), np_dt),
             np.asarray(dt, np_dt), np.asarray(last_pose, np_dt)],
            self.device)
        pc, rig, dtype = self.cfg.prior, self.rig, self.dtype
        res = estimate_essential(uv0, uv1, mask_t, rig.focal[0].to(dtype),
                                 rig.principal[0].to(dtype),
                                 num_hypotheses=pc.num_hypotheses,
                                 thres_px=pc.ransac_thres_px,
                                 min_flow_px=pc.min_flow_px)
        delta = motion_prior_unscaled(res, rig.T_cam_veh[0].to(dtype), speed,
                                      dt_t)
        return read_back([pose_ops.compose(delta, last)])[0].astype(
            np.float64)

    def _is_keyframe(self, tracklets: Tracklets, stamp: float,
                     pose_adj: np.ndarray) -> bool:
        """The keyframe gates (KeyframeSelector) on the device against the
        newest keyframe; one upload and one read. Stamps go in as (Δt, 0):
        epoch-style stamps (~1.7e9 s) quantize to ~256 s in float32, which
        would break the time gate."""
        last_stamp, last_pose = self.adjuster.keyframe_poses()[-1]
        m = self._padded_matches(tracklets, stamp, last_stamp)
        if m is not None:
            uv_new, uv_old, mmask = m
        else:
            N = self.cfg.capacity.max_landmarks
            uv_new = uv_old = np.zeros((N, 2))
            mmask = np.zeros((N,), bool)
        dt_kf = float(stamp) - float(last_stamp)
        np_dt = numpy_float(self.dtype)
        args = upload([np.asarray(uv_new, np_dt), np.asarray(uv_old, np_dt),
                       mmask, np.asarray(pose_adj[:4], np_dt),
                       np.asarray(last_pose[:4], np_dt),
                       np.asarray(dt_kf, np_dt), np.asarray(0.0, np_dt)],
                      self.device)
        decision = select_keyframe(*args, self.cfg)
        return bool(read_back([decision.is_keyframe])[0])

    # ------------------------------------------------------------------

    def process_frame(self, stamp: float, tracklets: Tracklets,
                      pose_prior: Optional[np.ndarray] = None,
                      track_camera: Optional[dict] = None) -> FrameResult:
        """One frame through the full §3.1/§3.3 call stack.

        track_camera: optional global-track-id → camera-index routing for
        multi-camera rigs (every track observed by one camera; the
        reference's landmark_to_cameras lookup, keyframe.cpp:43-59). The
        5-point prior and the keyframe flow gates run on camera 0's tracks;
        push / pose-only / BA consume all cameras."""
        cfg = self.cfg
        # camera-0 view for the single-camera stages (prior, flow gates):
        # cross-camera pixel flow is meaningless
        if track_camera:
            from .tracklets import filter_tracklets
            keep = np.array([track_camera.get(int(t), 0) == 0
                             for t in tracklets.ids], bool)
            tl_cam0 = filter_tracklets(tracklets, keep)
        else:
            tl_cam0 = tracklets
        # first frame: fixed identity keyframe (mono_lidar.cpp:301-325)
        if self.adjuster.num_keyframes == 0:
            pose0 = np.array([1.0, 0, 0, 0, 0, 0, 0])
            self.adjuster.push(stamp, tracklets, pose0, FIX_POSE,
                               track_camera=track_camera)
            self._last_solve_stamp = stamp
            self._last_frame_stamp = stamp
            r = FrameResult(stamp, pose0, True, False)
            self.trajectory.append(r)
            self._heartbeat(stamp)
            return r

        # ---- pose prior + motion-only scale correction -----------------
        if pose_prior is None:
            pose_prior = self._motion_prior(tl_cam0, stamp)
        pose_adj = self.adjuster.adjust_pose_only(stamp, pose_prior, tracklets,
                                                  track_camera=track_camera)

        # ---- keyframe selection ----------------------------------------
        is_kf = self._is_keyframe(tl_cam0, stamp, pose_adj)

        solved = False
        if is_kf:
            fixation = FIX_SCALE if self.adjuster.num_keyframes == 1 else FIX_NONE
            self.adjuster.push(stamp, tracklets, pose_adj, fixation,
                               track_camera=track_camera)
            # throttled solve (mono_lidar.cpp:243-262)
            if (self.adjuster.num_keyframes >= 3
                    and stamp - self._last_solve_stamp
                    >= 0.98 * cfg.window.time_between_solves_sec):
                self.adjuster.deactivate_keyframes()
                self.adjuster.update_labels(
                    tracklets, cfg.regularization.shrubbery_weight)
                self.adjuster.solve()
                self._last_solve_stamp = stamp
                solved = True
                pose_adj = self.adjuster.keyframe_poses()[-1][1]

        self._last_frame_stamp = stamp
        r = FrameResult(stamp, np.asarray(pose_adj, np.float64), is_kf, solved)
        self.trajectory.append(r)
        self._heartbeat(stamp)
        return r

    def _heartbeat(self, stamp: float) -> None:
        """Per-frame diagnostics tick (reference: updater_.update() driven
        by the node's spin; here driven by the frame loop)."""
        self.sensor_status.heartbeat(stamp)
        self.frame_rate.tick(stamp)
        self.diagnostics.update()

    # ------------------------------------------------------------------

    def poses_kitti(self) -> np.ndarray:
        """Per-frame KITTI 4×4 matrices (origin←frame), dump-format
        equivalent of mono_lidar.cpp:275-300."""
        arr = np.stack([f.pose for f in self.trajectory])
        return ph.to_matrix(ph.inverse(arr))


class LidarOdometry(MonoOdometry):
    """Limo/Limo2: tracklets carry lidar depth; groundplane landmarks anchor
    scale. Same skeleton as MonoOdometry — the depth residuals and gp wiring
    activate inside BundleAdjuster when observations carry d ≥ 0 and labels
    mark ground points."""

    def process_frame(self, stamp: float, tracklets: Tracklets,
                      pose_prior: Optional[np.ndarray] = None,
                      ground_ids: Optional[np.ndarray] = None) -> FrameResult:
        if ground_ids is not None and ground_ids.size:
            gl = set(int(i) for i in ground_ids)
            lab = tracklets.label.copy()
            for r, tid in enumerate(tracklets.ids):
                if int(tid) in gl:
                    lab[r] = 7  # cityscapes "road"
            tracklets = Tracklets(
                stamps=tracklets.stamps, uvd=tracklets.uvd, mask=tracklets.mask,
                ids=tracklets.ids, age=tracklets.age,
                is_outlier=tracklets.is_outlier, label=lab)
        return super().process_frame(stamp, tracklets, pose_prior)
