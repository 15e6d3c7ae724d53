"""Per-frame scan odometry on dense track tensors.

The reference evaluates KITTI sequences one frame per callback
(``MonoLidar::callbackSubscriber``, mono_lidar.cpp:88-373). This module is
that per-frame pipeline on fixed-shape tensors: constant-velocity prior with
the lidar range-rate rescue → motion-only refinement and its plausibility
guard → keyframe gates → push (depth backprojection / midpoint
triangulation) → connectivity deactivation → label flow → throttled
selection + trimmed windowed BA → post-solve guard. Tracks arrive as a dense
per-frame tensor ``[F, L, 3]`` keyed by landmark slot.

The step is a plain function on tensors, run frame by frame in a Python
loop (:func:`run_sequence`). Shapes stay fixed and selection stays as
masks: the push is computed on every frame and selected with
``torch.where(take_kf, …)``, field by field. The one exception is the
windowed solve, which is far too expensive to run speculatively: the step
reads ``do_solve`` back to the host once per frame and runs the solve only
when it is set. :class:`ScanStats` counts those reads beside the solves'
own (``SolveInfo.n_host_syncs``); each is a ``limo.sync`` span
(``utils.profiling.host_read``), and each frame a ``limo.scan_step`` span
that sets the frame id of the spans inside it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..frontend.essential import estimate_essential, motion_prior_unscaled
from ..geometry import pose as pose_ops
from ..geometry import pose_host
from ..geometry import quaternion as quat
from ..geometry.camera import backproject, viewing_ray
from ..geometry.triangulation import triangulate_batch
from ..selection.keyframe import select_keyframe
from ..selection.landmark import norm, take
from ..solver.pose_only import pose_only_step
from ..solver.trimmed import solve_trimmed
from ..state import Window, empty_window
from ..utils.profiling import host_read, span, traced
from ..window_manager import (DEFAULT_GROUND_LABELS, DEFAULT_OUTLIER_LABELS,
                              DEFAULT_SHRUBBERY_LABELS, selection_for_solve)


class ScanState(NamedTuple):
    window: Window
    lm_outlier: torch.Tensor     # [L] label/flag-based rejects (updateLabels)
    sel_mask: torch.Tensor       # [L] last solve's landmark selection
    newest_slot: torch.Tensor    # int32 — slot of the newest keyframe
    n_kf: torch.Tensor           # int32 — keyframes pushed so far
    cur_pose: torch.Tensor       # [7] latest pose incl. solve corrections
    vel: torch.Tensor            # [7] frame delta relative(refined_t, out_{t-1})
    last_kf_pose: torch.Tensor   # [7]
    last_kf_stamp: torch.Tensor
    last_kf_uv: torch.Tensor     # [L,2] pixels at the last keyframe
    last_kf_uv_valid: torch.Tensor  # [L]
    last_solve_stamp: torch.Tensor
    last_stamp: torch.Tensor     # previous frame's stamp (per-frame dt)
    last_d: torch.Tensor         # [L] previous frame's per-slot lidar depth
    last_d_valid: torch.Tensor   # [L] — depth-rate speed observation
    speed: torch.Tensor          # m/s from the last two keyframes
                                 # (mono_lidar.cpp:168-185; default 13 m/s
                                 # before two keyframes exist)


class FrameOut(NamedTuple):
    pose: torch.Tensor           # [7] vehicle←origin per frame
    is_keyframe: torch.Tensor    # bool
    solved: torch.Tensor         # bool (an accepted solve)
    cost: torch.Tensor           # BA cost of the frame's attempted solve
                                 # (0 when none; not masked by the guard)
    prior: torch.Tensor          # [7] motion prior fed to pose-only
    refined: torch.Tensor        # [7] raw pose-only result (pre-guard)
    speed_obs: torch.Tensor      # lidar range-rate speed observation (m/s)
    n_rate: torch.Tensor         # int32 — depth-carrying persisting slots
    po_ok: torch.Tensor          # bool — refinement within plausibility
    n_usable: torch.Tensor       # int32 — landmarks usable for pose-only


@dataclass
class ScanStats:
    """Host-side counts of one scan step's frames."""

    frames: int = 0
    host_syncs: int = 0          # device→host reads: one per frame
                                 # (do_solve) plus each solve's own
    solves: list = field(default_factory=list)  # SolveInfo per attempted solve


def _identity(dtype, device):
    """The identity pose, made on the device (no host copy)."""
    return (torch.arange(7, device=device) == 0).to(dtype)


def _slot_mask(k, K, device):
    return torch.arange(K, device=device) == k


def init_state(cap, dtype=torch.float32, default_speed: float = 13.0,
               device="cuda") -> ScanState:
    w = empty_window(cap, dtype, device)
    L = w.L
    p0 = _identity(dtype, device)
    flags = torch.zeros((L,), dtype=torch.bool, device=device)
    stamp = lambda v: torch.full((), v, dtype=w.stamps.dtype, device=device)
    i32 = torch.zeros((), dtype=torch.int32, device=device)
    return ScanState(
        window=w,
        lm_outlier=flags,
        sel_mask=flags.clone(),
        newest_slot=i32,
        n_kf=i32.clone(),
        cur_pose=p0,
        vel=p0.clone(),
        last_kf_pose=p0.clone(),
        last_kf_stamp=stamp(-1e9),
        last_kf_uv=torch.zeros((L, 2), dtype=dtype, device=device),
        last_kf_uv_valid=flags.clone(),
        last_solve_stamp=stamp(-1e9),
        last_stamp=stamp(-1e9),
        last_d=torch.full((L,), -1.0, dtype=dtype, device=device),
        last_d_valid=flags.clone(),
        speed=torch.full((), default_speed, dtype=dtype, device=device),
    )


def _oldest_two(stamps, valid):
    """Slots of the oldest and second-oldest active keyframes."""
    big = torch.full_like(stamps, torch.inf)
    s = torch.where(valid, stamps, big)
    k0 = torch.argmin(s)
    k1 = torch.argmin(torch.where(_slot_mask(k0, s.shape[0], s.device), big, s))
    return k0.to(torch.int32), k1.to(torch.int32)


def _write_slot(stamps, valid):
    """Slot for the next keyframe: any free slot first, else evict the
    oldest active one (its pose was already emitted per frame — the scan
    equivalent of the host allocator's archive-and-reuse)."""
    small = torch.full_like(stamps, -torch.inf)
    return torch.argmin(torch.where(valid, stamps, small)).to(torch.int32)


def _fixation(stamps, active):
    """Fixation invariant: oldest active = Pose, second oldest = Scale."""
    k0, k1 = _oldest_two(stamps, active)
    K = stamps.shape[0]
    return (_slot_mask(k0, K, stamps.device) & active,
            _slot_mask(k1, K, stamps.device) & active)


def _deactivate(window: Window, newest_slot, cfg) -> Window:
    """``deactivateKeyframes`` (bundle_adjuster_keyframes.cpp:907-987) on
    the device: the newest ``min_window`` keyframes stay active; beyond
    ``max_window`` always deactivated; in between active iff sharing
    ≥ ``min_num_connecting_landmarks`` landmarks with the newest keyframe
    (getCommonLandmarkIds :88-111). Active landmarks shrink to those observed
    in the window (:950-960); fixation reassigned: oldest active → Pose,
    second-oldest → Scale (:962-986)."""
    wc = cfg.window
    stamps, valid = window.stamps, window.kf_valid
    newer = valid[None, :] & (stamps[None, :] > stamps[:, None])
    rank = newer.sum(dim=1)                                   # 0 = newest
    obs_any = window.obs_mask.any(dim=-1)                     # [L,K]
    common = (obs_any & take(obs_any, newest_slot, 1)[:, None]
              & window.lm_valid[:, None]).sum(dim=0)
    keep = valid & ((rank < wc.min_size_optimization_window)
                    | ((rank < wc.max_size_optimization_window)
                       & (common >= wc.min_num_connecting_landmarks)))
    obs_mask = window.obs_mask & keep[None, :, None]
    lm_valid = window.lm_valid & obs_mask.any(dim=2).any(dim=1)
    fix_pose, fix_scale = _fixation(stamps, keep)
    return window._replace(kf_valid=keep, obs_mask=obs_mask, lm_valid=lm_valid,
                           fix_pose=fix_pose, fix_scale=fix_scale,
                           plane_valid=window.plane_valid & keep)


def _push_keyframe(window: Window, slot, stamp, pose, uvd, valid, plane,
                   plane_ok, rig):
    """Write a keyframe into ``slot`` (evicting its previous occupant) and
    initialize new landmarks — the device-side ``push``
    (bundle_adjuster_keyframes.cpp:289-329: depth-backproject if any camera
    measured depth, else midpoint triangulation; failures retried on later
    pushes). Also stores the frame's local groundplane estimate into the
    keyframe slot (``Keyframe::local_ground_plane_``).

    Returns (window, fresh [L] — rows whose landmark was initialized by THIS
    push; label-derived per-row state is reset for them so a reused row never
    inherits the previous occupant's labels)."""
    K, L = window.K, window.L
    dtype = window.poses.dtype
    ohb = _slot_mask(slot, K, window.poses.device)           # [K]

    # evict + write the keyframe slot
    stamps = torch.where(ohb, stamp, window.stamps)
    poses = torch.where(ohb[:, None], pose[None, :], window.poses)
    kf_valid = window.kf_valid | ohb
    new_obs = torch.where(valid[:, None, None, None], uvd[:, None, None, :],
                          torch.zeros_like(uvd[:, None, None, :]))
    obs = torch.where(ohb[None, :, None, None], new_obs, window.obs)
    obs_mask = torch.where(ohb[None, :, None], valid[:, None, None],
                           window.obs_mask)
    planes = torch.where(ohb[:, None], plane[None, :].to(dtype), window.planes)
    plane_valid = torch.where(ohb, plane_ok, window.plane_valid)

    # ---- landmark initialization ------------------------------------
    f = rig.focal[0].to(dtype)
    pp = rig.principal[0].to(dtype)
    tcv = rig.T_cam_veh[0].to(dtype)
    T_origin_veh = pose_ops.inverse(pose)
    T_veh_cam = pose_ops.inverse(tcv)

    # (a) depth backprojection for rows observed with d > 0
    d = uvd[:, 2]
    p_cam = backproject(uvd[:, :2], d, f[None], pp)
    p_origin = pose_ops.apply(T_origin_veh, pose_ops.apply(T_veh_cam, p_cam))
    init_depth = valid & (d > 0) & (~window.lm_valid)

    # (b) midpoint triangulation from all window observations (≥ 2 rays)
    uv_all = obs[:, :, 0, :2]                               # [L,K,2]
    ray_cam = viewing_ray(uv_all, f.expand(L, K), pp)
    T_origin_cam = pose_ops.compose(pose_ops.inverse(poses), T_veh_cam[None])
    rot_only = pose_ops.make(T_origin_cam[:, :4],
                             torch.zeros_like(T_origin_cam[:, 4:]))
    rays_o = pose_ops.apply(rot_only[None], ray_cam)        # [L,K,3]
    centers = T_origin_cam[None, :, 4:].expand(L, K, 3)
    rmask = obs_mask[:, :, 0] & kf_valid[None, :]
    tri_pos, tri_ok = triangulate_batch(rays_o, centers, rmask)
    init_tri = tri_ok & (~window.lm_valid) & (~init_depth) \
        & take(obs_mask[:, :, 0], slot, 1)

    lm_pos = torch.where(init_depth[:, None], p_origin,
                         torch.where(init_tri[:, None], tri_pos, window.lm_pos))
    lm_valid = window.lm_valid | init_depth | init_tri
    fresh = init_depth | init_tri
    # a freshly initialized row resets per-landmark state (row slots are
    # reused after GC on long drives — the previous occupant's depth flag,
    # label weight, and gp flag must not leak)
    lm_has_depth = torch.where(fresh, init_depth, window.lm_has_depth) \
        | (lm_valid & valid & (d > 0))
    lm_weight = torch.where(fresh, torch.ones_like(window.lm_weight),
                            window.lm_weight)
    lm_is_gp = window.lm_is_gp & ~fresh

    # GC: rows with no observation left in the window lose their landmark
    seen = (obs_mask[:, :, 0] & kf_valid[None, :]).any(dim=1)
    lm_valid = lm_valid & seen

    fix_pose, fix_scale = _fixation(stamps, kf_valid)
    return window._replace(
        stamps=stamps, poses=poses, kf_valid=kf_valid,
        fix_pose=fix_pose, fix_scale=fix_scale,
        planes=planes, plane_valid=plane_valid,
        lm_pos=lm_pos, lm_valid=lm_valid, lm_has_depth=lm_has_depth,
        lm_weight=lm_weight, lm_is_gp=lm_is_gp,
        obs=obs, obs_mask=obs_mask), fresh


def _select(cond, new, old):
    """Field by field: ``new`` where ``cond`` else ``old``."""
    return type(old)(*[torch.where(cond, b, a) for a, b in zip(old, new)])


def make_scan_step(rig, cfg, prior_mode: Optional[str] = None,
                   outlier_labels=DEFAULT_OUTLIER_LABELS,
                   shrubbery_labels=DEFAULT_SHRUBBERY_LABELS,
                   ground_labels=DEFAULT_GROUND_LABELS):
    """Build the per-frame scan step function.

    Returns ``step(state, frame) -> (state, FrameOut)`` with
    ``frame = (stamp, uvd [L,3], valid [L], label [L], flag_outlier [L],
    plane [4], plane_ok, ext_prior [7], ext_prior_ok)`` on the rig's
    device; use :func:`frame_arrays` to build the per-frame channels with
    reference defaults. ``step.stats`` (:class:`ScanStats`) counts its
    frames, host reads and attempted solves.

    prior_mode: "constant_velocity" (the motion-model prior; the default via
    cfg.prior.scan_prior_mode), "essential" (a fresh 5-point prior against
    the last keyframe on every frame, the constant-velocity prior where
    RANSAC fails) or "identity".

    outlier_labels, shrubbery_labels, ground_labels: the label ontology —
    which class ids count as dynamic (rejected), vegetation (down-weighted)
    and ground (groundplane landmarks). The defaults are the reference's
    cityscapes sets (``window_manager.DEFAULT_*_LABELS``); the step reads
    labels only through these sets, made once on the rig's device here.
    """
    if prior_mode is None:
        prior_mode = cfg.prior.scan_prior_mode
    if prior_mode not in ("constant_velocity", "essential", "identity"):
        raise ValueError(f"unknown prior_mode {prior_mode!r}")
    wcfg = cfg.window
    pc = cfg.prior
    device = rig.focal.device
    table = lambda labels: torch.as_tensor(sorted(labels), dtype=torch.int32,
                                           device=device)
    out_tab, shrub_tab, ground_tab = (table(outlier_labels),
                                      table(shrubbery_labels),
                                      table(ground_labels))
    stats = ScanStats()

    def isin(label, tab):
        return (label[:, None] == tab[None, :]).any(dim=1)

    @traced("limo.essential")
    def essential_prior(st, uvd, valid, stamp, cv_prior):
        """A fresh 5-point prior against the last keyframe from the per-slot
        track rows (both-valid mask = the reference's getMatches at two
        stamps, general_helpers.hpp:44-76), unit translation scaled by
        speed·Δt (getMotionUnscaled :209-231); the constant-velocity prior
        where RANSAC fails."""
        dtype = cv_prior.dtype
        # the constant-velocity rotation, in the camera frame, breaks the
        # planar two-fold (R, t) ambiguity of the cheirality vote
        tcv = rig.T_cam_veh[0].to(dtype)
        dv = pose_ops.relative(cv_prior, st.last_kf_pose)
        q_guess = pose_ops.compose(
            tcv, pose_ops.compose(dv, pose_ops.inverse(tcv)))[:4]
        res = estimate_essential(
            st.last_kf_uv, uvd[:, :2], valid & st.last_kf_uv_valid,
            rig.focal[0].to(dtype), rig.principal[0].to(dtype),
            num_hypotheses=pc.scan_num_hypotheses,
            thres_px=pc.ransac_thres_px, min_flow_px=pc.min_flow_px,
            q_guess=q_guess)
        dt_kf = torch.clamp_min((stamp - st.last_kf_stamp).to(dtype), 1e-3)
        # scale trust is a freshness question: while keyframes arrive on
        # schedule the measured speed applies unchanged; after a gap (a
        # standstill) the displacement is bounded by the budget floor
        kf_period = cfg.keyframe_selection.time_between_keyframes_sec
        speed_eff = torch.where(
            dt_kf <= 2.5 * kf_period, st.speed,
            torch.minimum(st.speed, pc.guard_floor_m / dt_kf))
        delta = motion_prior_unscaled(res, tcv, speed_eff, dt_kf)
        ess = pose_ops.normalize(pose_ops.compose(delta, st.last_kf_pose))
        return torch.where(res.ok, ess, cv_prior)

    def step(st: ScanState, frame):
        with span("limo.scan_step", frame=stats.frames):
            return frame_step(st, frame)

    def frame_step(st: ScanState, frame):
        (stamp, uvd, valid, label, flag_out, plane, plane_ok,
         ext_prior, ext_prior_ok) = frame
        dtype = st.cur_pose.dtype
        dev = st.cur_pose.device
        uvd = uvd.to(dtype)
        identity = _identity(dtype, dev)
        stats.frames += 1

        # Speed-derived per-frame plausibility budget:
        # budget_m = max(floor, factor × max(speed, floor_speed) × dt).
        dt_frame = torch.clamp((stamp - st.last_stamp).to(dtype), 1e-3, 1.0)
        budget_m = torch.clamp_min(
            pc.guard_speed_factor
            * torch.clamp_min(st.speed, pc.guard_floor_speed) * dt_frame,
            pc.guard_floor_m)
        budget_rad = pc.guard_rotation_rad

        # Lidar depth-rate speed observation: the median range rate over
        # persisting depth-carrying slots arbitrates SCALE at the prior, the
        # pose-only acceptance, the post-solve guard and the speed state.
        d_cur = uvd[:, 2]
        both = valid & st.last_d_valid & (d_cur > 0)
        rate = (st.last_d - d_cur) / dt_frame
        plaus = both & (torch.abs(rate) < 80.0)
        n_rate = plaus.sum(dtype=torch.int32)
        rs = torch.sort(torch.where(plaus, rate,
                                    torch.full_like(rate, torch.inf))).values
        last = rate.shape[0] - 1
        i_med = torch.clamp(torch.div(n_rate - 1, 2, rounding_mode="floor"),
                            0, last)
        i_hi = torch.clamp(torch.div(n_rate, 2, rounding_mode="floor"),
                           0, last)
        speed_obs = torch.clamp_min(
            0.5 * (take(rs, i_med) + take(rs, i_hi)), 0.0)
        lidar_has = n_rate >= pc.lidar_min_rates

        def lidar_agrees(sp):
            # a speed estimate is lidar-consistent when no observation
            # exists, or it sits within the configured band
            return (~lidar_has) | (torch.abs(sp - speed_obs) <= torch.clamp_min(
                pc.lidar_band_frac * speed_obs, pc.lidar_band_floor_m_s))

        # ---- 1. prior (mono_lidar.cpp:155-187); an external prior
        # (mono_lidar.cpp:119-150) overrides the internal estimate ----------
        if prior_mode in ("constant_velocity", "essential"):
            # plausibility clamp: a glitched frame must not teleport the
            # prior out of the solver's basin
            tv = st.vel[4:]
            tn = norm(tv)
            tv = tv * torch.clamp_max(budget_m / torch.clamp_min(tn, 1e-9), 1.0)
            speed_inst = tn / dt_frame
            rescue = lidar_has & (~lidar_agrees(speed_inst))
            # keep the motion direction when it exists; a near-zero vel
            # has no direction — fall back to straight-ahead (T_cur←prev
            # translation for forward motion is −m·e_x)
            fwd = -(torch.arange(3, device=dev) == 0).to(dtype)
            dirv = torch.where(tn > 0.2, tv / torch.clamp_min(tn, 1e-9), fwd)
            tv = torch.where(rescue, dirv * speed_obs * dt_frame, tv)
            wv = quat.qlog(st.vel[:4])
            wn = norm(wv)
            wv = wv * torch.clamp_max(budget_rad / torch.clamp_min(wn, 1e-9),
                                      1.0)
            vel = pose_ops.make(quat.qexp(wv), tv)
            prior = pose_ops.normalize(pose_ops.compose(vel, st.cur_pose))
        else:  # "identity" — no motion model
            prior = st.cur_pose
        if prior_mode == "essential":
            prior = essential_prior(st, uvd, valid, stamp, prior)
        prior = torch.where(st.n_kf > 0, prior, identity)
        prior = torch.where(ext_prior_ok, ext_prior.to(dtype), prior)

        # ---- 2. motion-only refinement (adjustPoseOnly) ----------------
        window = st.window
        lm_mask = window.lm_valid & (~st.lm_outlier) \
            & (st.sel_mask | (~st.sel_mask.any()))
        n_usable = (lm_mask & valid).sum(dtype=torch.int32)
        po = pose_only_step(prior, window.lm_pos, uvd[:, None, :],
                            (valid & lm_mask)[:, None], lm_mask, rig, cfg,
                            max_iters=cfg.solver.pose_only_max_iterations,
                            compensate_rotation=(
                                cfg.solver.scan_pose_only_compensate_rotation),
                            lm_weight=window.lm_weight,
                            graduated_init=(
                                cfg.solver.scan_pose_only_graduated_init))
        # plausibility bound on the refinement, on the relative pose
        # (vehicle displacement |Δp| and Δθ), and lidar scale arbitration
        po_speed = norm(pose_ops.relative(po.pose, st.cur_pose)[4:]) / dt_frame
        po_ok = ((norm(pose_ops.relative(po.pose, prior)[4:]) < budget_m)
                 & (quat.qangle(po.pose[:4], prior[:4]) < budget_rad)
                 & lidar_agrees(po_speed))
        refined = torch.where((st.n_kf >= 1) & (n_usable >= 10) & po_ok,
                              po.pose, prior)
        refined = pose_ops.normalize(refined)

        # ---- 3. keyframe gates (KeyframeSelector) ----------------------
        dec = select_keyframe(uvd[:, :2], st.last_kf_uv,
                              valid & st.last_kf_uv_valid,
                              refined[:4], st.last_kf_pose[:4],
                              stamp, st.last_kf_stamp, cfg)
        take_kf = dec.is_keyframe | (st.n_kf == 0)

        # ---- 4. push (slot write + landmark init + plane), deactivation
        # at push, selected by take_kf ----------------------------------
        with span("limo.push"):
            slot = _write_slot(window.stamps, window.kf_valid)
            pushed, fresh = _push_keyframe(window, slot, stamp, refined, uvd,
                                           valid, plane, plane_ok, rig)
            pushed = _deactivate(pushed, slot, cfg)
            window = _select(take_kf, pushed, window)
            fresh = fresh & take_kf
            newest_slot = torch.where(take_kf, slot, st.newest_slot)

        # ---- 5. label flow (updateLabels, :388-431) ---------------------
        lm_outlier = (st.lm_outlier & (~fresh)) \
            | (valid & (flag_out | isin(label, out_tab)))
        shrub = valid & isin(label, shrub_tab)
        ground = valid & isin(label, ground_tab)
        window = window._replace(
            lm_weight=torch.where(shrub, cfg.regularization.shrubbery_weight,
                                  window.lm_weight),
            lm_is_gp=window.lm_is_gp | ground)

        # ---- 6. throttled windowed solve (mono_lidar.cpp:243-262) ------
        do_solve = take_kf & (st.n_kf + 1 >= 3) & (
            stamp - st.last_solve_stamp >= 0.98 * wcfg.time_between_solves_sec)
        stats.host_syncs += 1
        sel_mask = st.sel_mask
        cost = torch.zeros((), dtype=dtype, device=dev)
        if host_read(do_solve):
            with span("limo.selection"):
                w = _deactivate(window, newest_slot, cfg)
                k0, k1 = _oldest_two(w.stamps, w.kf_valid)
                sel, _ = selection_for_solve(w, newest_slot, k0, k1,
                                             lm_outlier, rig, cfg)
            solved_window, sel2, info = solve_trimmed(w, sel, rig, cfg)
            stats.host_syncs += info.n_host_syncs
            stats.solves.append(info)
            cost = info.final_cost.to(dtype)

            # Post-solve plausibility guard: reject the whole solve if it
            # moves the newest pose further than any plausible BA
            # refinement (vehicle displacement and rotation vs the same
            # speed-derived budget, and the lidar range rate).
            solved_pose = take(solved_window.poses, newest_slot)
            jump = norm(pose_ops.relative(solved_pose, refined)[4:])
            ang = quat.qangle(solved_pose[:4], refined[:4])
            solved_speed = norm(pose_ops.relative(
                solved_pose, st.cur_pose)[4:]) / dt_frame
            solve_ok = (jump < budget_m) & (ang < budget_rad) \
                & lidar_agrees(solved_speed)
            window = _select(solve_ok, solved_window, window)
            sel_mask = torch.where(solve_ok, sel2.lm_selected, st.sel_mask)
            do_solve = do_solve & solve_ok

        # pose after a solve: the newest keyframe's optimized pose
        out_pose = torch.where(do_solve, take(window.poses, newest_slot),
                               refined)

        vel = torch.where(st.n_kf > 0,
                          pose_ops.normalize(
                              pose_ops.relative(refined, st.cur_pose)),
                          identity)
        # speed from the last two keyframes (mono_lidar.cpp:168-185),
        # lidar-arbitrated: it scales every budget
        kf_dt = (stamp - st.last_kf_stamp).to(dtype)
        sp_new = norm(pose_ops.relative(out_pose, st.last_kf_pose)[4:]) \
            / torch.clamp_min(kf_dt, 1e-3)
        sp_new = torch.where(lidar_agrees(sp_new), sp_new, speed_obs)
        speed = torch.where(take_kf & (st.n_kf > 0) & (kf_dt > 1e-6),
                            sp_new, st.speed)
        has_d = valid & (uvd[:, 2] > 0)
        st2 = ScanState(
            window=window,
            lm_outlier=lm_outlier,
            sel_mask=sel_mask,
            newest_slot=newest_slot,
            n_kf=st.n_kf + take_kf.to(torch.int32),
            cur_pose=out_pose,
            vel=vel,
            last_kf_pose=torch.where(take_kf, out_pose, st.last_kf_pose),
            last_kf_stamp=torch.where(take_kf, stamp, st.last_kf_stamp),
            last_kf_uv=torch.where(take_kf, uvd[:, :2], st.last_kf_uv),
            last_kf_uv_valid=torch.where(take_kf, valid, st.last_kf_uv_valid),
            last_solve_stamp=torch.where(do_solve, stamp, st.last_solve_stamp),
            last_stamp=stamp,
            last_d=torch.where(has_d, uvd[:, 2], -1.0),
            last_d_valid=has_d,
            speed=speed,
        )
        return st2, FrameOut(pose=out_pose, is_keyframe=take_kf,
                             solved=do_solve, cost=cost,
                             prior=prior, refined=po.pose,
                             speed_obs=speed_obs, n_rate=n_rate,
                             po_ok=po_ok, n_usable=n_usable)

    step.stats = stats
    return step


def frame_arrays(stamps, uvd_seq, valid_seq, cfg, dtype=torch.float32,
                 labels=None, outlier_flags=None, planes=None, planes_ok=None,
                 priors=None, prior_valid=None, stamp_dtype=torch.float32,
                 device="cuda"):
    """Assemble the full per-frame channel tuple the scan step consumes, on
    ``device`` (each channel copied there once).

    Defaults reproduce the reference launch graph when a channel is absent:
    labels −2 (no semantics attached), no outlier flags, a per-frame
    groundplane prior at ``height_over_ground`` below the vehicle origin
    (the reference's plane default when the estimator publishes nothing),
    no external prior."""
    F = len(stamps)
    L = np.asarray(uvd_seq).shape[1]
    lab = (np.full((F, L), -2) if labels is None else np.asarray(labels))
    flg = (np.zeros((F, L), bool) if outlier_flags is None
           else np.asarray(outlier_flags))
    if planes is None:
        hog = cfg.landmark_selection.height_over_ground
        pl = np.broadcast_to(np.array([0.0, 0.0, 1.0, hog]), (F, 4))
        pl_ok = np.ones((F,), bool)
    else:
        pl = np.asarray(planes)
        pl_ok = (np.ones((F,), bool) if planes_ok is None
                 else np.asarray(planes_ok))
    if priors is None:
        p = np.zeros((F, 7))
        p[:, 0] = 1.0
        p_ok = np.zeros((F,), bool)
    else:
        p = np.asarray(priors)
        p_ok = (np.ones((F,), bool) if prior_valid is None
                else np.asarray(prior_valid))
    on = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a)).to(
        device=device, dtype=dt)
    return (on(stamps, stamp_dtype), on(uvd_seq, dtype),
            on(valid_seq, torch.bool), on(lab, torch.int32),
            on(flg, torch.bool), on(pl, dtype), on(pl_ok, torch.bool),
            on(p, dtype), on(p_ok, torch.bool))


def run_sequence(stamps, uvd_seq, valid_seq, rig, cfg, priors=None,
                 prior_valid=None, dtype=torch.float32, labels=None,
                 outlier_flags=None, planes=None, planes_ok=None,
                 device="cuda"):
    """Run a whole sequence through the scan step, frame by frame.

    stamps [F], uvd_seq [F,L,3], valid_seq [F,L] with L equal to the
    landmark capacity (cfg.capacity.max_landmarks), as numpy arrays; the
    frame channels are put on ``device`` once, before the loop, and ``rig``
    must live there. ``priors`` [F,7] optionally injects external pose
    priors (the reference's tf-odometry path); ``labels`` [F,L] per-row
    semantic labels; ``planes`` [F,4] per-frame groundplane estimates in
    the vehicle frame. Returns (final ScanState, FrameOut with a frame
    axis)."""
    st = init_state(cfg.capacity, dtype, cfg.prior.default_speed, device)
    step = make_scan_step(rig, cfg)
    xs = frame_arrays(stamps, uvd_seq, valid_seq, cfg, dtype, labels,
                      outlier_flags, planes, planes_ok, priors, prior_valid,
                      stamp_dtype=st.window.stamps.dtype, device=device)
    return _run_frames(step, st, xs)


def _run_frames(step, st, xs):
    """``step`` over every frame of the channels ``xs`` from state ``st``:
    (final state, FrameOut with a frame axis)."""
    outs = []
    for i in range(xs[0].shape[0]):
        st, out = step(st, tuple(x[i] for x in xs))
        outs.append(out)
    return st, FrameOut(*[torch.stack(f) for f in zip(*outs)])


def _stack(trees, device):
    """Stack equal-structured (nested) named tuples of tensors along a new
    leading axis, on ``device``."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack([t.to(device) for t in trees])
    return type(first)(*[_stack(list(f), device) for f in zip(*trees)])


def run_batch(stamps_b, uvd_b, valid_b, rig, cfg, priors_b=None,
              prior_valid_b=None, dtype=torch.float32, labels_b=None,
              outlier_flags_b=None, planes_b=None, planes_ok_b=None,
              device="cuda"):
    """Many sequences, one result: every input has a leading batch axis
    ``B`` (numpy, as :func:`run_sequence` takes them) and the result is
    (final ScanState [B,...], FrameOut [B,F,...]) on ``device`` (``rig`` is
    copied there if it lives elsewhere) — the reference's serial
    per-sequence evaluation loop behind one call. :func:`run_fleet` on the
    one device ``[device]``.

    The reference vmaps one compiled ``lax.scan`` over the batch. This step
    cannot be vmapped: it reads ``do_solve`` on the host every frame and
    runs the windowed solve only when it is set, and the trimmed solve
    reads its phase flags on the host (``solver/trimmed.py``,
    ``solver/lm.py``). So the batch is a loop over :func:`run_sequence`,
    one sequence after another, and element *b* is bit for bit
    ``run_sequence`` of sequence *b*: no lane pays another's solves or LM
    iterations, as vmap's both-branch selects and batch-max loops make
    them. The cost is B times one sequence: the card idles between the
    host's launches, and a masked solve across sequences that would fill
    it is not built (ROADMAP). The reference's ``vmap_chunk`` bounds the
    width of the vmapped group; with no vmap there is no width to bound,
    so it has no counterpart."""
    return run_fleet(stamps_b, uvd_b, valid_b, rig, cfg, priors_b,
                     prior_valid_b, dtype, labels_b, outlier_flags_b,
                     planes_b, planes_ok_b, devices=[device])


def fleet_devices(devices=None):
    """The devices of a fleet: ``devices`` as torch devices, else every
    visible card; raises when there is none (a fleet never falls back to
    the CPU unless the caller names it)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("run_fleet: no visible CUDA device")
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("run_fleet: empty device list")
    return devices


def run_fleet(stamps_b, uvd_b, valid_b, rig, cfg, priors_b=None,
              prior_valid_b=None, dtype=torch.float32, labels_b=None,
              outlier_flags_b=None, planes_b=None, planes_ok_b=None,
              devices=None):
    """A sequence fleet dealt over ``devices`` (default: every visible
    card) — the reference's serial per-sequence KITTI evaluation loop
    (kitti_eval_script.sh:54-115) behind one call: sequence *b* runs
    through :func:`run_sequence` on ``devices[b % D]`` (the rig copied
    there) and the results are stacked on ``devices[0]``. The list takes
    the place of the reference's mesh ``data`` axis; there are no
    cross-sequence collectives.

    The fleet is serial: one host thread runs the sequences one after
    another (see :func:`run_batch`), so D cards hold the sequences' memory
    but run no faster than one, and a fleet of B costs B times one
    sequence on any number of cards. On one card it is :func:`run_batch`.
    The reference pads the batch to a multiple of the data axis (replaying
    sequence 0) because GSPMD splits an array evenly; dealing sequences
    out needs no even split, so there is no padding."""
    devices = fleet_devices(devices)
    at = lambda x, b: None if x is None else np.asarray(x)[b]
    rigs = {}
    runs = []
    for b in range(np.asarray(stamps_b).shape[0]):
        dev = devices[b % len(devices)]
        if dev not in rigs:
            rigs[dev] = type(rig)(*[x.to(dev) for x in rig])
        runs.append(run_sequence(
            at(stamps_b, b), at(uvd_b, b), at(valid_b, b), rigs[dev], cfg,
            priors=at(priors_b, b), prior_valid=at(prior_valid_b, b),
            dtype=dtype, labels=at(labels_b, b),
            outlier_flags=at(outlier_flags_b, b), planes=at(planes_b, b),
            planes_ok=at(planes_ok_b, b), device=dev))
    finals, outs = zip(*runs)
    return _stack(finals, devices[0]), _stack(outs, devices[0])


def make_tuning_runner(rig, cfg):
    """Build the tuning-scan runner once: ``run(rows, st, xs) -> (final
    ScanState [G,...], FrameOut [G,F,...])``.

    Grid rows are ``(depth_thres, reprojection_thres)`` or
    ``(depth_thres, reprojection_thres, shrubbery_weight)`` — the full
    reference sweep (``res/tune_parameters_kitti.py:3-17``). Each row
    becomes a config (``tuning.apply_point``; a two-column row keeps
    ``cfg``'s shrubbery weight) and runs through
    :func:`make_scan_step` from the one initial state ``st`` over the one
    set of frame channels ``xs`` (:func:`frame_arrays`), which every row
    shares and none copies. The loss scales reach the CUDA kernels as
    runtime scalars (``a2r``, ``a2d``) and the shrubbery weight enters the
    landmark weights, so every row runs the hand-written kernels."""
    from .tuning import apply_point

    def run(rows, st, xs):
        finals, outs = [], []
        for row in np.asarray(rows, np.float64).tolist():
            shrub = row[2] if len(row) >= 3 else \
                cfg.regularization.shrubbery_weight
            step = make_scan_step(rig, apply_point(cfg, row[0], row[1],
                                                   shrub))
            final, out = _run_frames(step, st, xs)
            finals.append(final)
            outs.append(out)
        device = st.cur_pose.device
        return _stack(finals, device), _stack(outs, device)

    return run


def run_tuning_grid(stamps, uvd_seq, valid_seq, rig, cfg, grid,
                    dtype=torch.float32, labels=None,
                    outlier_flags=None, planes=None, planes_ok=None,
                    device="cuda"):
    """Every tuning grid point over the same sequence, one call.

    The reference's parameter search replays the full dataset once per grid
    point (``res/tune_parameters_kitti.py:3-17`` × ``kitti_eval_script.sh``).
    ``grid [G,2]`` rows are ``(depth_thres, reprojection_thres)``,
    ``grid [G,3]`` adds ``shrubbery_weight``; the sequence's channels are
    put on ``device`` (where ``rig`` lives) once and shared by every point
    (:func:`make_tuning_runner`). The points run one after another, each
    as :func:`run_sequence` would run it under its config.

    The reference splits a wide grid into chunks to stay under a TPU's
    generated-code ceiling (``max_chunk``, ``CODE_SIZE_BUDGET_MIB``);
    nothing here is compiled per grid width, so there is no chunking.

    Returns (final ScanState [G,...], FrameOut [G,F,...]) on ``device``.
    """
    grid = np.asarray(grid, np.float64)
    if grid.ndim != 2 or grid.shape[1] not in (2, 3):
        raise ValueError(f"grid rows must have 2 or 3 columns, got "
                         f"{grid.shape}")
    st = init_state(cfg.capacity, dtype, cfg.prior.default_speed, device)
    run = make_tuning_runner(rig, cfg)
    data = frame_arrays(stamps, uvd_seq, valid_seq, cfg, dtype, labels,
                        outlier_flags, planes, planes_ok,
                        stamp_dtype=st.window.stamps.dtype, device=device)
    return run(grid, st, data)


def poses_kitti(frame_out: FrameOut) -> np.ndarray:
    """FrameOut → [F,4,4] KITTI origin←vehicle matrices (host numpy)."""
    return pose_host.to_matrix(pose_host.inverse(
        np.asarray(torch.as_tensor(frame_out.pose).cpu(), np.float64)))
