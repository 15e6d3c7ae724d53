"""7-parameter pose ops (quat wxyz + translation xyz), batched.

Convention (reference ``definitions.hpp:75-83``): a pose array
``p = [qw,qx,qy,qz,tx,ty,tz]`` denotes the isometry ``T = Trans(t) ∘ Rot(q)``,
i.e. ``apply(p, x) = R(q) @ x + t``. BA keyframe poses are stored
*keyframe ← origin* (world-to-body), so ``apply(pose_kf, p_origin)`` yields the
point in keyframe coordinates (``keyframe_bundle_adjustment/README.md:128-141``).
"""

from __future__ import annotations

import torch

from .quaternion import (
    qboxplus,
    qconj,
    qfrom_axis_angle,
    qfrom_matrix,
    qidentity,
    qmul,
    qnormalize,
    qrot,
    qto_matrix,
)


def identity(dtype=torch.float32, device=None):
    return torch.cat([qidentity(dtype, device),
                      torch.zeros(3, dtype=dtype, device=device)])


def rotation(p):
    return p[..., :4]


def translation(p):
    return p[..., 4:]


def make(q, t):
    return torch.cat([q, t], dim=-1)


def apply(p, x):
    """apply(p, x) = R(q) x + t; x has shape [...,3] broadcastable with p."""
    return qrot(p[..., :4], x) + p[..., 4:]


def compose(p1, p2):
    """T1 ∘ T2 as pose arrays: apply(compose(p1,p2), x) == apply(p1, apply(p2, x))."""
    q = qmul(p1[..., :4], p2[..., :4])
    t = qrot(p1[..., :4], p2[..., 4:]) + p1[..., 4:]
    return make(q, t)


def inverse(p):
    qi = qconj(qnormalize(p[..., :4]))
    return make(qi, -qrot(qi, p[..., 4:]))


def relative(p1, p0):
    """T1 ∘ T0⁻¹ — the delta the reference uses everywhere for consecutive
    world-to-body poses (e.g. ``cost_functors_ceres.hpp:236``)."""
    return compose(p1, inverse(p0))


def boxplus(p, delta):
    """⊞ with 6-dof tangent [rot(3), trans(3)]: q' = exp(w) ⊗ q, t' = t + dt.

    Matches the reference's ProductParameterization(Quaternion ⊞, Identity(3))
    (``bundle_adjuster_keyframes.cpp:161-196``).
    """
    q = qboxplus(p[..., :4], delta[..., :3])
    t = p[..., 4:] + delta[..., 3:]
    return make(q, t)


def boxplus_circular_2d(p, delta):
    """⊞ with 2-dof planar circular-arc tangent [yaw, arc_length].

    Mirrors the reference's ``CircularMotionPlus2d``
    (local_parameterizations.hpp:170-227): the delta pose translates by the
    chord of a circle segment (dx = r·sin(yaw), dy = r·(1−cos yaw), r =
    arc/yaw; straight-line fallback below 1e-3 rad) and rotates by yaw
    around z, then left-composes: p' = delta_pose ∘ p."""
    yaw = delta[..., 0]
    arc = delta[..., 1]
    small = torch.abs(yaw) < 1e-3
    safe_yaw = torch.where(small, torch.ones_like(yaw), yaw)
    r = arc / safe_yaw
    dx = torch.where(small, arc, r * torch.sin(yaw))
    dy = torch.where(small, torch.zeros_like(yaw), r * (1.0 - torch.cos(yaw)))
    zero = torch.zeros_like(yaw)
    q = torch.stack([torch.cos(yaw / 2), zero, zero, torch.sin(yaw / 2)], -1)
    t = torch.stack([dx, dy, zero], -1)
    return compose(make(q, t), p)


def boxplus_fix_scale_circular(p, delta, fix_value=1.0):
    """⊞ with 3-dof euler tangent [pitch, yaw, roll] under fixed step length.

    Mirrors the reference's ``FixScaleCircularMotionPlus``
    (local_parameterizations.hpp:229-272), which works in camera coords
    (z forward, x right): the pose advances a fixed arc ``fix_value`` along a
    circle segment bent by ``yaw`` (rotation around the y axis) — forward step
    ``dz = sinc(yaw)·fix``, lateral step ``dx = (1−cos yaw)/yaw·fix`` — and the
    rotation delta (Rz(roll)·Ry(yaw)·Rx(pitch), the ceres euler convention) is
    *right*-composed: ``q' = q ⊗ q_delta``."""
    pitch, yaw, roll = delta[..., 0], delta[..., 1], delta[..., 2]
    small = torch.abs(yaw) < 1e-3
    safe_yaw = torch.where(small, torch.ones_like(yaw), yaw)
    dz = torch.where(small, torch.full_like(yaw, fix_value),
                     torch.sin(yaw) / safe_yaw * fix_value)
    dx = torch.where(small, torch.zeros_like(yaw),
                     (1.0 - torch.cos(yaw)) / safe_yaw * fix_value)
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    ex, ey, ez = (eye[i].expand(delta.shape[:-1] + (3,)) for i in range(3))
    q_delta = qmul(qfrom_axis_angle(ez, roll),
                   qmul(qfrom_axis_angle(ey, yaw), qfrom_axis_angle(ex, pitch)))
    q = qmul(p[..., :4], q_delta)
    zero = torch.zeros_like(dx)
    t = p[..., 4:] + torch.stack([dx, zero, dz], -1)
    return make(q, t)


def tangent_basis(poses, mode):
    """Per-keyframe 6-dof tangent-space basis for alternate motion
    parameterizations (``setParameterization``,
    bundle_adjuster_keyframes.cpp:172-183).

    Returns ``(B [K,6,6], dim_mask [6])``: Gauss-Newton runs on the reduced
    coordinates ``d`` with full-tangent step ``B @ d`` (columns beyond the
    mode's dof are zeroed via ``dim_mask``). The bases equal the jacobian of
    the corresponding reference retraction at delta=0, so first-order
    behavior matches the Ceres local parameterizations exactly:

    - ``full_dof``:      identity (ProductParameterization(Quaternion, Id3)).
    - ``fix_rotation``:  identity basis, rotation dims masked out.
    - ``circular_2d``:   2 dof [yaw, arc] (``CircularMotionPlus2d``,
      local_parameterizations.hpp:170-227). Left-composition
      ``p' = delta(yaw,arc) ∘ p`` linearizes to w = yaw·ẑ,
      dt = arc·x̂ + yaw·(ẑ×t) in the keyframe frame.
    """
    K = poses.shape[0]
    kw = dict(dtype=poses.dtype, device=poses.device)
    eye = torch.eye(6, **kw).expand(K, 6, 6)
    if mode == "full_dof":
        return eye, torch.ones((6,), **kw)
    if mode == "fix_rotation":
        return eye, _dim_mask(3, 6, kw)
    if mode == "circular_2d":
        t = poses[:, 4:]
        zeros = torch.zeros((K,), **kw)
        ones = torch.ones((K,), **kw)
        halves = torch.full((K,), 0.5, **kw)
        # column 0: yaw — rotation about z (half-angle chart: qexp has
        # |w| = θ/2, so dw/dyaw = ẑ/2) plus the induced translation ẑ×t
        col_yaw = torch.stack([zeros, zeros, halves, -t[:, 1], t[:, 0], zeros], -1)
        # column 1: arc — forward translation along the keyframe x axis
        col_arc = torch.stack([zeros, zeros, zeros, ones, zeros, zeros], -1)
        zero_col = torch.zeros((K, 6), **kw)
        B = torch.stack([col_yaw, col_arc, zero_col, zero_col, zero_col,
                         zero_col], -1)
        return B, _dim_mask(0, 2, kw)
    raise ValueError(f"unknown motion parameterization: {mode!r}")


def _dim_mask(lo, hi, kw):
    """[6] mask, 1 on dims lo..hi-1, made on the device (no host copy)."""
    i = torch.arange(6, device=kw["device"])
    return ((i >= lo) & (i < hi)).to(kw["dtype"])


def normalize(p):
    return make(qnormalize(p[..., :4]), p[..., 4:])


def to_matrix(p):
    """pose7 → 4x4 homogeneous matrix."""
    R = qto_matrix(qnormalize(p[..., :4]))
    t = p[..., 4:]
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=p.dtype,
                          device=p.device).expand(p.shape[:-1] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def from_matrix(m):
    return make(qfrom_matrix(m[..., :3, :3]), m[..., :3, 3])
