"""BundleAdjuster — the optimization-graph manager (host orchestration).

The reference package's ``limo_tpu/window_manager.py``, the equivalent of
``BundleAdjusterKeyframes`` (``bundle_adjuster_keyframes.{hpp,cpp}``): a
host-side slot allocator keeps numpy mirrors of the fixed-shape ``Window``
(copied as they are from the reference), and every numeric step runs on
the device on the full arrays. The device steps are direct calls of the
port's own functions: :func:`selection_for_solve` (the solve-time selector
stack: outlier flags → cheirality → voxel sparsification → AddDepth(gp)
guarantees, then the groundplane and scale wiring) + ``solve_trimmed`` in
:meth:`BundleAdjuster.solve`, and ``pose_only_step`` in
:meth:`BundleAdjuster.adjust_pose_only`.

Host ↔ device traffic: the mirrors go up in one packed upload per call
(``utils.transfer.upload``), and each device step's results come back in
one read (``utils.transfer.read_back``).

API mirrors the reference (push / solve / adjust_pose_only /
deactivate_keyframes / update_labels — ``bundle_adjuster_keyframes.hpp:40-335``).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

import numpy as np
import torch

from .config import LimoConfig
from .geometry import pose as pose_ops
from .geometry import pose_host as ph
from .selection.landmark import (add_depth_scheme, cheirality_mask, norm,
                                 kf_positions, take, voxel_scheme)
from .solver.pose_only import pose_only_step
from .solver.trimmed import solve_trimmed
from .state import Selection, Window
from .utils.profiling import traced
from .utils.transfer import numpy_float, read_back, upload

if TYPE_CHECKING:
    from .pipeline.tracklets import Tracklets

# fixation codes (reference Keyframe::FixationStatus, keyframe.hpp:29)
FIX_NONE, FIX_POSE, FIX_SCALE = 0, 1, 2

# cityscapes label sets preloaded by the reference
# (bundle_adjuster_keyframes.hpp:226-255, res/outlier_labels.yaml)
DEFAULT_OUTLIER_LABELS = frozenset(
    [0, 1, 2, 3, 5, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, -1])
DEFAULT_SHRUBBERY_LABELS = frozenset([21, 22, 23])
DEFAULT_GROUND_LABELS = frozenset([6, 7, 8, 9])


def selection_for_solve(window: Window, newest, k0, k1, lm_outlier, rig, cfg):
    """Landmark selection + solve wiring, on the device.

    Mirrors the reference solve()'s selector stack: outlier flags →
    cheirality → voxel sparsification → AddDepth(gp) guarantees; then the
    scale / groundplane regularization weight logic (:703-728).

    newest/k0/k1: slots of the newest and two oldest active keyframes
    (0-d tensors). Returns (Selection, voxel categories [L])."""
    dtype = window.lm_pos.dtype
    device = window.lm_pos.device
    K = window.K
    keep = cheirality_mask(window, rig) & (~lm_outlier) & window.lm_valid
    # second-newest active keyframe by stamp (slots are NOT time-ordered once
    # the allocator reuses evicted slots) — the flow anchor for the near bin
    slots = torch.arange(K, device=device)
    small = torch.full_like(window.stamps, -torch.inf)
    s = torch.where(window.kf_valid & (slots != newest), window.stamps, small)
    last_kf = torch.argmax(s).to(torch.int32)
    vox = voxel_scheme(window, newest, keep, cfg, last_kf=last_kf)
    selected = add_depth_scheme(
        window, vox.selected, keep & window.lm_is_gp,
        cfg.landmark_selection.min_number_landmarks_gp)
    selected = selected & keep

    # gp residual wiring: nearest active keyframe with enabled plane,
    # weight 10*(1 − d/25) when d < 25 (addGroundPlaneResiduals :517-562)
    d_all = norm(window.lm_pos[:, None] - kf_positions(window)[None])
    d_all = torch.where((window.kf_valid & window.plane_valid)[None], d_all,
                        torch.full_like(d_all, torch.inf))
    gp_kf = torch.argmin(d_all, dim=1).to(torch.int32)
    d_min = d_all.amin(dim=1)
    reg = cfg.regularization
    gmax = reg.gp_max_distance
    zero = torch.zeros_like(d_min)
    gp_w = torch.where(d_min < gmax,
                       reg.gp_height_weight * (1.0 - d_min / gmax), zero)
    gp_w = torch.where(window.lm_is_gp & selected, gp_w, zero)

    # scale logic (:703-728): counts decide regularization weight
    depth_cnt = torch.sum((window.obs_mask & (window.obs[..., 2] > 0)
                           & selected[:, None, None]
                           & window.lm_has_depth[:, None, None]
                           & window.kf_valid[None, :, None]).to(torch.int32),
                          dtype=torch.int32)
    gp_cnt = torch.sum((gp_w > 0).to(torch.int32), dtype=torch.int32)
    observed = (depth_cnt > 10) | (gp_cnt > 10)
    n_obs = torch.clamp_min(depth_cnt + gp_cnt, 1).to(dtype)
    scale_w = torch.where(
        observed,
        torch.where(gp_cnt < 30, reg.scale_reg_weight_observed_base / n_obs,
                    torch.zeros_like(n_obs)),
        torch.full_like(n_obs, reg.scale_reg_weight_unobserved))
    # two oldest active keyframes anchor the scale
    t0 = pose_ops.translation(pose_ops.relative(take(window.poses, k1),
                                                take(window.poses, k0)))
    target = torch.sqrt(torch.sum(t0 * t0))
    plane_dist_fixed = depth_cnt < 10  # :731-737

    as_i32 = lambda k: torch.as_tensor(k, device=device).to(torch.int32)
    sel = Selection(
        lm_selected=selected,
        gp_kf=gp_kf,
        gp_weight=gp_w,
        scale_kf0=as_i32(k0),
        scale_kf1=as_i32(k1),
        scale_target=target,
        scale_weight=scale_w,
        plane_dist_fixed=plane_dist_fixed,
    )
    return sel, vox.category


class NotEnoughKeyframesException(Exception):
    """Reference: bundle_adjuster_keyframes.hpp:59-68 — solve needs >=3."""


class KeyframeNotFoundException(Exception):
    """Reference: bundle_adjuster_keyframes.hpp:69-77."""


def _np_pose_inv(p):
    return ph.inverse(np.asarray(p, np.float64))


def _np_pose_apply(p, x):
    return ph.apply(np.asarray(p, np.float64), np.asarray(x, np.float64))


def _triangulate_np(rays, centers):
    """Host midpoint triangulation (triangulator.hpp:51-75 math, numpy)."""
    eye = np.eye(3)
    P = eye[None] - rays[:, :, None] * rays[:, None, :]
    A = P.sum(0)
    b = np.einsum("nij,nj->i", P, centers)
    det = np.linalg.det(A)
    if abs(det) < 1e-9:
        return None
    return np.linalg.solve(A, b)


class BundleAdjuster:
    """Sliding-window keyframe bundle adjuster with landmark/keyframe
    scheduling — the ``BundleAdjusterKeyframes`` equivalent. ``device``:
    where the solves run (the card unless the caller asks for the CPU)."""

    def __init__(self, rig, cfg: Optional[LimoConfig] = None,
                 dtype=torch.float32, device="cuda",
                 outlier_labels=DEFAULT_OUTLIER_LABELS,
                 shrubbery_labels=DEFAULT_SHRUBBERY_LABELS,
                 ground_labels=DEFAULT_GROUND_LABELS):
        self.cfg = cfg or LimoConfig()
        self.rig = rig
        self.dtype = dtype
        self.device = torch.device(device)
        cap = self.cfg.capacity
        self.K, self.L, self.C = cap.max_keyframes, cap.max_landmarks, cap.max_cameras
        # host mirrors of the Window arrays; rig constants on the host
        self._focal = rig.focal.detach().cpu().numpy().astype(np.float64)
        self._principal = rig.principal.detach().cpu().numpy().astype(
            np.float64)
        self._tcv = rig.T_cam_veh.detach().cpu().numpy().astype(np.float64)

        self._stamps = np.zeros(self.K)
        self._poses = np.tile(np.array([1.0, 0, 0, 0, 0, 0, 0]), (self.K, 1))
        self._kf_valid = np.zeros(self.K, bool)
        self._fixation = np.zeros(self.K, np.int32)
        self._planes = np.tile(np.array([0.0, 0, 1, 0]), (self.K, 1))
        self._plane_valid = np.zeros(self.K, bool)
        self._lm_pos = np.zeros((self.L, 3))
        self._lm_valid = np.zeros(self.L, bool)
        self._lm_weight = np.ones(self.L)
        self._lm_has_depth = np.zeros(self.L, bool)
        self._lm_is_gp = np.zeros(self.L, bool)
        self._lm_id = np.full(self.L, -1, np.int64)
        self._lm_known = np.zeros(self.L, bool)   # position initialized
        self._lm_outlier = np.zeros(self.L, bool)  # label/flag-based rejects
        self._obs = np.zeros((self.L, self.K, self.C, 3))
        self._obs[..., 2] = -1.0
        self._obs_mask = np.zeros((self.L, self.K, self.C), bool)

        self._kf_order: List[int] = []       # active+inactive slots, oldest→newest
        self._lm_slot: Dict[int, int] = {}   # global landmark id → slot
        self._archive: Dict[float, np.ndarray] = {}  # stamp → final pose (evicted)
        self._last_selection: Optional[np.ndarray] = None  # [L] bool
        self._last_categories: Optional[np.ndarray] = None
        # unselected-count + last-seen bookkeeping with 10 s GC — the
        # LandmarkSelector's markUnselected/clean/getUnselectedLandmarks
        # surface (landmark_selector.hpp:260-275); kept for API parity and
        # diagnostics (the reference never consumes these counts)
        self._unselected_counts: Dict[int, int] = {}
        self._unselected_last_seen: Dict[int, float] = {}

    # ------------------------------------------------------------------
    # keyframe/landmark bookkeeping
    # ------------------------------------------------------------------

    @property
    def num_keyframes(self) -> int:
        return len(self._kf_order)

    def keyframe_poses(self):
        """(stamp, pose keyframe←origin) for all active keyframes, time order."""
        return [(self._stamps[s], self._poses[s].copy()) for s in self._kf_order]

    def newest_slot(self) -> int:
        if not self._kf_order:
            raise KeyframeNotFoundException("no keyframes")
        return self._kf_order[-1]

    def _alloc_kf_slot(self) -> int:
        for s in range(self.K):
            if s not in self._kf_order:
                return s
        # evict the oldest (archive its pose)
        old = self._kf_order.pop(0)
        self._archive[self._stamps[old]] = self._poses[old].copy()
        self._clear_kf_slot(old)
        return old

    def _clear_kf_slot(self, s: int):
        self._kf_valid[s] = False
        self._fixation[s] = FIX_NONE
        self._plane_valid[s] = False
        self._obs_mask[:, s, :] = False
        self._obs[:, s, :, :2] = 0.0
        self._obs[:, s, :, 2] = -1.0

    def _alloc_lm_slot(self, lm_id: int) -> Optional[int]:
        free = np.flatnonzero(~self._lm_valid)
        if free.size == 0:
            return None
        s = int(free[0])
        self._lm_slot[lm_id] = s
        self._lm_valid[s] = True
        self._lm_known[s] = False
        self._lm_id[s] = lm_id
        self._lm_weight[s] = 1.0
        self._lm_has_depth[s] = False
        self._lm_is_gp[s] = False
        self._lm_outlier[s] = False
        return s

    def _free_lm_slot(self, slot: int):
        lm_id = self._lm_id[slot]
        self._lm_valid[slot] = False
        self._lm_known[slot] = False
        self._lm_id[slot] = -1
        self._obs_mask[slot, :, :] = False
        self._lm_slot.pop(int(lm_id), None)

    # ------------------------------------------------------------------
    # push — reference bundle_adjuster_keyframes.cpp:289-329
    # ------------------------------------------------------------------

    def push(self, stamp: float, tracklets: "Tracklets", pose: np.ndarray,
             fixation: int = FIX_NONE, plane: Optional[np.ndarray] = None,
             track_camera: Optional[Dict[int, int]] = None):
        """Add a keyframe: store pose, assign measurements from tracklets at
        ``stamp``, initialize unknown landmarks by depth-backprojection or
        midpoint triangulation.

        track_camera: optional global-track-id → camera-index routing for
        multi-camera rigs (the reference's landmark_to_cameras lookup,
        keyframe.cpp:43-59)."""
        s = self._alloc_kf_slot()
        self._kf_order.append(s)
        self._stamps[s] = stamp
        self._poses[s] = np.asarray(pose, np.float64)
        self._kf_valid[s] = True
        self._fixation[s] = fixation
        if plane is not None:
            self._planes[s] = np.asarray(plane, np.float64)
            self._plane_valid[s] = True
        else:
            hog = self.cfg.landmark_selection.height_over_ground
            self._planes[s] = np.array([0.0, 0.0, 1.0, hog])
            self._plane_valid[s] = True

        ids, uvd, _ = tracklets.measurements_at(stamp)
        f, pp, tcv = self._focal, self._principal, self._tcv
        new_ids = []
        cam_of = {}
        for tid, m in zip(ids, uvd):
            cam = track_camera.get(int(tid), 0) if track_camera else 0
            if cam >= self.C:
                continue
            slot = self._lm_slot.get(int(tid))
            if slot is None:
                slot = self._alloc_lm_slot(int(tid))
                if slot is None:
                    continue  # capacity full — skip (selector caps anyway)
                new_ids.append((int(tid), slot))
            cam_of[int(tid)] = cam
            self._obs[slot, s, cam] = m
            self._obs_mask[slot, s, cam] = True

        # initialize positions of landmarks new to the map; landmarks that
        # cannot yet be placed stay position-unknown and are retried on the
        # next push (reference push :310-314)
        for tid, slot in new_ids:
            cam = cam_of[tid]
            T_origin_cam = ph.inverse(ph.compose(tcv[cam], self._poses[s]))
            u, v, d = self._obs[slot, s, cam]
            if d >= 0:
                # containsDepth path (:37-48): backproject at measured depth
                p_cam = np.array([(u - pp[cam, 0]) / f[cam] * d,
                                  (v - pp[cam, 1]) / f[cam] * d, d])
                self._lm_pos[slot] = _np_pose_apply(T_origin_cam, p_cam)
                self._lm_has_depth[slot] = True
                self._lm_known[slot] = True
        self._retry_triangulation()
        # any landmark with a depth measurement anywhere keeps the flag
        if ids.size:
            has_d = uvd[:, 2] >= 0
            for tid, hd in zip(ids, has_d):
                slot = self._lm_slot.get(int(tid))
                if slot is not None and hd:
                    self._lm_has_depth[slot] = True
        return s

    def _retry_triangulation(self) -> None:
        """Attempt midpoint triangulation for every allocated landmark whose
        position is still unknown (needs ≥2 observing keyframes)."""
        for slot in np.flatnonzero(self._lm_valid & ~self._lm_known):
            p = self._triangulate_from_window(int(slot))
            if p is not None:
                self._lm_pos[slot] = p
                self._lm_known[slot] = True

    def _triangulate_from_window(self, slot: int) -> Optional[np.ndarray]:
        """Midpoint triangulation from all active-keyframe observations
        (getMeasurementsAndPoses :125-159 → triangulator)."""
        f, pp, tcv = self._focal, self._principal, self._tcv
        rays, centers = [], []
        for s in self._kf_order:
            for c in range(self.C):
                if not self._obs_mask[slot, s, c]:
                    continue
                u, v, _ = self._obs[slot, s, c]
                T_origin_cam = ph.inverse(ph.compose(tcv[c], self._poses[s]))
                ray_cam = np.array([(u - pp[c, 0]) / f[c], (v - pp[c, 1]) / f[c], 1.0])
                ray_cam /= np.linalg.norm(ray_cam)
                R = ph.qto_matrix(T_origin_cam[:4])
                rays.append(R @ ray_cam)
                centers.append(T_origin_cam[4:])
        if len(rays) < 2:
            return None
        return _triangulate_np(np.stack(rays), np.stack(centers))

    # ------------------------------------------------------------------
    # updateLabels — reference :388-431
    # ------------------------------------------------------------------

    def update_labels(self, tracklets: "Tracklets",
                      shrubbery_weight: float = 0.9, outlier_labels=None,
                      shrubbery_labels=None, ground_labels=None):
        ol = outlier_labels or DEFAULT_OUTLIER_LABELS
        sl = shrubbery_labels or DEFAULT_SHRUBBERY_LABELS
        gl = ground_labels or DEFAULT_GROUND_LABELS
        for tid, flag, lab in zip(tracklets.ids, tracklets.is_outlier, tracklets.label):
            slot = self._lm_slot.get(int(tid))
            if slot is None:
                continue
            if flag or int(lab) in ol:
                self._lm_outlier[slot] = True
            if int(lab) in sl:
                self._lm_weight[slot] = shrubbery_weight
            if int(lab) in gl:
                self._lm_is_gp[slot] = True

    # ------------------------------------------------------------------
    # deactivateKeyframes — reference :907-987
    # ------------------------------------------------------------------

    def deactivate_keyframes(self, min_connecting: Optional[int] = None,
                             min_window: Optional[int] = None,
                             max_window: Optional[int] = None):
        wc = self.cfg.window
        min_connecting = min_connecting or wc.min_num_connecting_landmarks
        min_window = min_window or wc.min_size_optimization_window
        max_window = max_window or wc.max_size_optimization_window
        n = len(self._kf_order)
        if n == 0:
            return
        newest = self._kf_order[-1]
        keep: List[int] = []
        for i, s in enumerate(self._kf_order):
            pos_from_new = n - 1 - i
            if pos_from_new < min_window:
                keep.append(s)
            elif pos_from_new >= max_window:
                pass  # always deactivated
            else:
                common = int(np.sum(
                    np.any(self._obs_mask[:, s], -1) & np.any(self._obs_mask[:, newest], -1)
                    & self._lm_valid))
                if common >= min_connecting:
                    keep.append(s)
        dropped = [s for s in self._kf_order if s not in keep]
        for s in dropped:
            self._archive[self._stamps[s]] = self._poses[s].copy()
            self._clear_kf_slot(s)
        self._kf_order = keep
        # shrink landmarks to those observed in the window (:950-960)
        observed = np.any(self._obs_mask[:, self._kf_order].reshape(self.L, -1), -1)
        for slot in np.flatnonzero(self._lm_valid & ~observed):
            self._free_lm_slot(int(slot))
        # fixation: oldest active → Pose, 2nd-oldest → Scale (:962-986)
        self._fixation[:] = FIX_NONE
        if self._kf_order:
            self._fixation[self._kf_order[0]] = FIX_POSE
        if len(self._kf_order) > 1:
            self._fixation[self._kf_order[1]] = FIX_SCALE

    # ------------------------------------------------------------------
    # device window construction
    # ------------------------------------------------------------------

    def to_window(self, extra: Sequence[np.ndarray] = ()):
        """The mirrors as a device Window, in one upload; ``extra`` arrays
        ride along and are returned after it: (Window, [extra tensors])."""
        dt = numpy_float(self.dtype)
        host = [self._stamps.astype(np.float32), self._poses.astype(dt),
                self._kf_valid, self._fixation == FIX_POSE,
                self._fixation == FIX_SCALE, self._planes.astype(dt),
                self._plane_valid, self._lm_pos.astype(dt),
                self._lm_valid & self._lm_known, self._lm_weight.astype(dt),
                self._lm_has_depth, self._lm_is_gp,
                self._lm_id.astype(np.int32), self._obs.astype(dt),
                self._obs_mask]
        dev = upload(host + list(extra), self.device)
        return Window(*dev[:len(host)]), dev[len(host):]

    # ------------------------------------------------------------------
    # solve — reference :629-767 (+ §3.2 call stack)
    # ------------------------------------------------------------------

    def _anchor_slots(self) -> np.ndarray:
        """(newest, oldest, second-oldest) active keyframe slots — the
        selection/scale anchors."""
        return np.array([self._kf_order[-1], self._kf_order[0],
                         self._kf_order[min(1, len(self._kf_order) - 1)]],
                        np.int64)

    def build_selection(self, window: Window) -> Selection:
        """Landmark selection + solve wiring (device-side); see
        :func:`selection_for_solve`. Stores the voxel categories."""
        anchors, lm_outlier = upload([self._anchor_slots(),
                                      self._lm_outlier], self.device)
        sel, cat = selection_for_solve(window, anchors[0], anchors[1],
                                       anchors[2], lm_outlier, self.rig,
                                       self.cfg)
        self._last_categories = read_back([cat])[0]
        return sel

    @traced("limo.ba_solve")
    def solve(self):
        """Landmark selection → trimmed windowed BA → writeback. The five
        results the mirrors need come back in one read.

        Raises NotEnoughKeyframesException below 3 keyframes (reference
        :630-632)."""
        if len(self._kf_order) < 3:
            raise NotEnoughKeyframesException(
                f"need >= 3 keyframes, have {len(self._kf_order)}")
        window, (anchors, lm_outlier) = self.to_window(
            (self._anchor_slots(), self._lm_outlier))
        sel, cat = selection_for_solve(window, anchors[0], anchors[1],
                                       anchors[2], lm_outlier, self.rig,
                                       self.cfg)
        w2, sel2, info = solve_trimmed(window, sel, self.rig, self.cfg)
        poses, lm_pos, planes, selected, cat = read_back(
            (w2.poses, w2.lm_pos, w2.planes, sel2.lm_selected, cat))
        act = self._kf_valid
        self._poses[act] = np.asarray(poses, np.float64)[act]
        self._planes[act] = np.asarray(planes, np.float64)[act]
        known = self._lm_valid & self._lm_known
        self._lm_pos[known] = np.asarray(lm_pos, np.float64)[known]
        self._last_categories = cat
        self._last_selection = selected
        self._mark_unselected(selected)
        return info

    def _mark_unselected(self, selected: np.ndarray,
                         gc_window_sec: float = 10.0):
        """markUnselected + clean (landmark_selector.hpp:260-275): bump the
        per-landmark unselected count for every valid landmark the selection
        skipped, stamp it with the newest keyframe time, and GC bookkeeping
        entries not seen within ``gc_window_sec``."""
        cur_ts = float(self._stamps[self._kf_order[-1]])
        for slot in np.flatnonzero(self._lm_valid & self._lm_known
                                   & ~selected):
            lm_id = int(self._lm_id[slot])
            self._unselected_counts[lm_id] = \
                self._unselected_counts.get(lm_id, 0) + 1
            self._unselected_last_seen[lm_id] = cur_ts
        cutoff = cur_ts - gc_window_sec
        for lm_id in [i for i, t in self._unselected_last_seen.items()
                      if t < cutoff]:
            self._unselected_counts.pop(lm_id, None)
            self._unselected_last_seen.pop(lm_id, None)

    def unselected_landmarks(self) -> Dict[int, int]:
        """getUnselectedLandmarks (landmark_selector.hpp:282-287): landmark
        id → how often it was passed over by selection (10 s retention)."""
        return dict(self._unselected_counts)

    # ------------------------------------------------------------------
    # adjustPoseOnly — reference :820-888 (motion-only BA)
    # ------------------------------------------------------------------

    @traced("limo.adjust_pose_only")
    def adjust_pose_only(self, stamp: float, pose_prior: np.ndarray,
                         tracklets: "Tracklets",
                         track_camera: Optional[Dict[int, int]] = None
                         ) -> np.ndarray:
        """Motion-only adjustment of a candidate (not yet pushed) frame
        against the last selection's landmarks: Cauchy reprojection + depth
        residuals, constant-velocity regularizer when recent rotation is
        small (weight 1−rot/0.03), quantile trimming, landmarks fixed,
        ≤4 LM iterations (reference :820-888). ``track_camera`` routes each
        measurement to its observing camera (multi-cam rigs)."""
        if len(self._kf_order) < 2:
            return np.asarray(pose_prior)
        if self._last_selection is None:
            # before the first windowed solve, correct against the full
            # landmark map (depth-backprojected landmarks are metric from
            # frame 0)
            selection = self._lm_valid.copy()
        else:
            selection = self._last_selection
        # gather candidate-frame measurements aligned to landmark slots
        obs = np.zeros((self.L, self.C, 3))
        obs[..., 2] = -1.0
        mask = np.zeros((self.L, self.C), bool)
        ids, uvd, _ = tracklets.measurements_at(stamp)
        for tid, m in zip(ids, uvd):
            slot = self._lm_slot.get(int(tid))
            if slot is not None:
                cam = track_camera.get(int(tid), 0) if track_camera else 0
                if cam >= self.C:
                    continue
                obs[slot, cam] = m
                mask[slot, cam] = True
        lm_mask = selection & self._lm_valid & np.any(mask, -1)

        # constant-velocity regularizer from the two newest keyframes
        speed_reg = None
        s0 = self._kf_order[-1]
        s1 = self._kf_order[-2]
        gate = self.cfg.regularization.speed_reg_rotation_gate
        rot_diff = float(ph.qangle(self._poses[s0][:4], self._poses[s1][:4]))
        if rot_diff < gate:
            weight = 1.0 * (1.0 - rot_diff / gate)
            dt_before = self._stamps[s0] - self._stamps[s1]
            dt_cur = stamp - self._stamps[s0]
            if dt_cur > 0 and dt_before > 0:
                p_before_inv = _np_pose_inv(self._poses[s0])
                vel = ph.translation(ph.compose(
                    self._poses[s0], ph.inverse(self._poses[s1]))) / dt_before
                speed_reg = [p_before_inv, vel, np.array(dt_cur),
                             np.array(weight)]

        dt = numpy_float(self.dtype)
        host = [np.asarray(pose_prior, dt), self._lm_pos.astype(dt),
                obs.astype(dt), mask, lm_mask, self._lm_weight.astype(dt)]
        if speed_reg is not None:
            host += [np.asarray(x, dt) for x in speed_reg]
        dev = upload(host, self.device)
        pose, lm_pos, obs_t, mask_t, lm_mask_t, lm_weight = dev[:6]
        res = pose_only_step(
            pose, lm_pos, obs_t, mask_t, lm_mask_t, self.rig, self.cfg,
            speed_reg=tuple(dev[6:]) if speed_reg is not None else None,
            max_iters=self.cfg.solver.pose_only_max_iterations,
            compensate_rotation=self.cfg.solver.pose_only_compensate_rotation,
            lm_weight=lm_weight)
        return read_back([res.pose])[0].astype(np.float64)
