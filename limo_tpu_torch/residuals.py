"""Residual functions — the reference cost functors in PyTorch.

Reference: ``keyframe_bundle_adjustment/internal/cost_functors_ceres.hpp``
(each function's docstring cites its functor). All functions are pure,
batched over leading axes, and return ``(residual, valid)`` where
``valid=False`` reproduces the Ceres "return false ⇒ drop residual" semantics
as a mask (invalid residuals are zeroed by the caller, keeping shapes static).

Jacobians are taken w.r.t. *local tangents* (pose ⊞ in
:mod:`limo_tpu_torch.geometry.pose`) with ``torch.func``, matching the
reference's local parameterizations.
"""

from __future__ import annotations

import torch

from .geometry import pose as pose_ops
from .geometry.camera import project

ROT_COMP_MIN_SQ = 0.01  # rotation-compensation guard (cost_functors_ceres.hpp:144)


def _ones_mask(res, drop_last: bool):
    shape = res.shape[:-1] if drop_last else res.shape
    return torch.ones(shape, dtype=torch.bool, device=res.device)


def _safe_norm(x, dim=-1, keepdim=False):
    """‖x‖ with a finite (zero) gradient at x=0.

    Plain ``torch.linalg.vector_norm`` has a NaN gradient at 0; residual rows
    attached to invalid keyframes sit exactly at 0 and are masked by weight —
    but NaN·0 = NaN would poison the assembled Hessian, so the guard is
    required.
    """
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    ok = sq > 1e-20
    return torch.where(ok, torch.sqrt(torch.where(ok, sq, torch.ones_like(sq))),
                       torch.zeros_like(sq))


def reprojection(pose_kf_origin, point_origin, uv_observed, focal, principal,
                 T_cam_veh, compensate_rotation: bool = False):
    """``ReprojectionErrorWithQuaternions`` (cost_functors_ceres.hpp:53-182).

    Project world landmark through T_cam_veh ∘ T_kf_origin, pinhole, residual =
    predicted − observed (pixels). With ``compensate_rotation`` the residual is
    divided by the norm of the rotation-only reprojection error (RotRocc,
    Buczko et al.), as used in motion-only adjustment.

    Returns (res [...,2], valid [...]).
    """
    point_veh = pose_ops.apply(pose_kf_origin, point_origin)
    point_cam = pose_ops.apply(T_cam_veh, point_veh)
    uv_pred, valid = project(point_cam, focal, principal)
    res = uv_pred - uv_observed

    if compensate_rotation:
        rot_only = pose_ops.make(
            pose_ops.rotation(pose_kf_origin),
            torch.zeros_like(pose_ops.translation(pose_kf_origin)))
        point_rot_cam = pose_ops.apply(T_cam_veh,
                                       pose_ops.apply(rot_only, point_origin))
        uv_rot, valid_rot = project(point_rot_cam, focal, principal)
        d = uv_rot - uv_observed
        rot_sq = torch.sum(d * d, dim=-1)
        rot_ok = rot_sq >= ROT_COMP_MIN_SQ
        valid = valid & valid_rot & rot_ok
        denom = torch.sqrt(torch.where(rot_ok, rot_sq, torch.ones_like(rot_sq)))
        res = res / denom[..., None]
    return res, valid


def landmark_depth(pose_kf_origin, point_origin, depth_measured, T_cam_veh):
    """``LandmarkDepthError`` (cost_functors_ceres.hpp:187-222): z of the
    landmark in the camera frame minus the lidar-measured depth."""
    point_cam = pose_ops.apply(T_cam_veh,
                               pose_ops.apply(pose_kf_origin, point_origin))
    res = point_cam[..., 2] - depth_measured
    return res[..., None], _ones_mask(res, False)


def pose_scale(pose1, pose0, target_scale):
    """``PoseRegularization`` (cost_functors_ceres.hpp:224-250):
    ‖translation(T1 ∘ T0⁻¹)‖ − target_scale."""
    delta_t = pose_ops.translation(pose_ops.relative(pose1, pose0))
    res = _safe_norm(delta_t, dim=-1) - target_scale
    return res[..., None], _ones_mask(res, False)


def speed(pose_cur, pose_before, pose_before2, dt_cur, dt_before):
    """``SpeedRegularization`` (cost_functors_ceres.hpp:253-298): scalar
    velocity difference of consecutive pose deltas."""
    v_cur = _safe_norm(pose_ops.translation(
        pose_ops.relative(pose_cur, pose_before)), dim=-1) / dt_cur
    v_before = _safe_norm(pose_ops.translation(
        pose_ops.relative(pose_before, pose_before2)), dim=-1) / dt_before
    res = v_cur - v_before
    return res[..., None], _ones_mask(res, False)


def speed_vector(pose_cur, pose_origin_before, vel_before, dt_cur):
    """``SpeedRegularizationVector2`` (cost_functors_ceres.hpp:300-353):
    3-vector velocity w.r.t. the (constant) previous pose minus the cached
    previous velocity. Only ``pose_cur`` is a variable.

    pose_origin_before: inverse of the previous keyframe pose (precomputed).
    """
    delta_t = pose_ops.translation(pose_ops.compose(pose_cur,
                                                    pose_origin_before))
    res = delta_t / dt_cur - vel_before
    return res, _ones_mask(res, True)


def groundplane_height(pose_kf_origin, plane_dir, plane_dist, point_origin):
    """``GroundPlaneHeightRegularization`` (cost_functors_ceres.hpp:355-392):
    signed distance of the landmark (in keyframe frame) to the local plane:
    n · p_kf + d."""
    point_kf = pose_ops.apply(pose_kf_origin, point_origin)
    res = torch.sum(plane_dir * point_kf, dim=-1) + plane_dist
    return res[..., None], _ones_mask(res, False)


def vector_difference(dir0, dir1):
    """``VectorDifferenceRegularization`` (cost_functors_ceres.hpp:394-414)."""
    res = dir0 - dir1
    return res, _ones_mask(res, True)


def translation_difference(pose0, pose1, pose2):
    """``TranslationDifferenceRegularization`` (cost_functors_ceres.hpp:440-469):
    constant-translation-delta (acceleration) regularizer:
    translation(T2∘T1⁻¹) − translation(T1∘T0⁻¹)."""
    d10 = pose_ops.translation(pose_ops.relative(pose1, pose0))
    d21 = pose_ops.translation(pose_ops.relative(pose2, pose1))
    res = d21 - d10
    return res, _ones_mask(res, True)


def groundplane_distance(dist0, dist1):
    """``GroundPlaneDistanceRegularization`` (cost_functors_ceres.hpp:507-526)."""
    res = torch.as_tensor(dist0 - dist1)
    return res[..., None], _ones_mask(res, False)


def groundplane_motion(pose0, pose1, plane_dir0):
    """``GroundPlaneMotionRegularization`` (cost_functors_ceres.hpp:528-555):
    normalized forward motion must be ⟂ plane normal: n · (Δt/‖Δt‖)."""
    delta_t = pose_ops.translation(pose_ops.relative(pose0, pose1))
    n = _safe_norm(delta_t, dim=-1, keepdim=True)
    unit = delta_t / torch.clamp_min(n, 1e-12)
    res = torch.sum(plane_dir0 * unit, dim=-1)
    return res[..., None], _ones_mask(res, False)


def motion_model_circular(pose_cur, pose_prev):
    """``MotionModelRegularization`` (motion_model_regularization.hpp:32-78):
    planar circular-arc motion model. Residuals: y-motion vs r(1−cos yaw) and
    z-motion vs 0 (declared in the reference but not wired into solve)."""
    delta = pose_ops.relative(pose_cur, pose_prev)
    t = pose_ops.translation(delta)
    q = pose_ops.rotation(delta)
    # yaw of the delta rotation (around z, vehicle convention)
    siny = 2.0 * (q[..., 0] * q[..., 3] + q[..., 1] * q[..., 2])
    cosy = 1.0 - 2.0 * (q[..., 2] ** 2 + q[..., 3] ** 2)
    yaw = torch.atan2(siny, cosy)
    x = t[..., 0]
    small = torch.abs(yaw) < 1e-3
    r = x / torch.where(small, torch.ones_like(yaw), torch.sin(yaw))
    y_pred = torch.where(small, torch.zeros_like(yaw),
                         r * (1.0 - torch.cos(yaw)))
    res = torch.stack([t[..., 1] - y_pred, t[..., 2]], dim=-1)
    return res, _ones_mask(res, True)
