"""Analytic jacobians of the observation, groundplane and regularizer
residuals.

The observation forms are what the CUDA assembly kernels compute in
registers (``csrc/assemble.cu``), and the plain PyTorch versions of those
kernels (:mod:`limo_tpu_torch.solver.cuda_assemble`) are built from them.
The groundplane-height and regularizer forms are the pose/plane blocks of
:mod:`limo_tpu_torch.solver.ba_core`. All are exact: the reference package
tests the observation forms against autodiff to machine precision, the
port's tests hold the others against ``torch.func`` in f64
(tests/test_torch_assemble.py), and its parity tests hold the assembled
blocks against the reference's autodiff path in f64.

Derivation (conventions of :mod:`limo_tpu_torch.geometry.pose`):
  p_veh = R(q) x + t           (pose keyframe←origin, ⊞: q'=exp(w)q, t'=t+dt)
  p_cam = R_cv p_veh + t_cv    (extrinsics constant)
  uv    = f * (p_x, p_y)/p_z + pp ;  depth residual = p_z − d

  ∂p_veh/∂w  = −2 [R(q) x]×   (half-angle tangent: exp(w) rotates by 2|w|)
  ∂p_veh/∂dt = I
  ∂p_veh/∂x  = R(q)
  ∂p_cam/∂·  = R_cv ∂p_veh/∂·
  ∂uv/∂p_cam = f/z [[1,0,−x/z],[0,1,−y/z]] ;  ∂depth/∂p_cam = (0,0,1)

A scalar residual r = vᵀ y(p) of a pose-dependent vector y has its tangent
row as a vector–Jacobian product, with (a × b) the cross product:
  y = R x + t        →  ∂r/∂w = 2 (R x) × v,  ∂r/∂dt = v,  ∂r/∂x = Rᵀ v
  u = t1 − R1 R0ᵀ t0 (translation of T1 ∘ T0⁻¹, ``pose.relative``)
                     →  ∂r/∂w1 = 2 v × (R1 R0ᵀ t0),  ∂r/∂dt1 = v,
                        ∂r/∂w0 = 2 t0 × h,  ∂r/∂dt0 = −h,  h = R0 R1ᵀ v
Planes retract as ``ba_core.plane_boxplus``: n' = (n+δn)/‖n+δn‖, d' = d+δd,
so ∂n̂/∂δn = (I − n̂n̂ᵀ)/‖n‖ at the stored (not necessarily unit) n.
"""

from __future__ import annotations

import torch

from ..geometry.quaternion import qnormalize


def skew(v):
    """[v]× for batched v [...,3] → [...,3,3]."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def _matvec(M, v):
    return (M @ v[..., None])[..., 0]


def obs_residual_jac(R_kf, t_kf, x, uvd, focal, principal, R_cv, t_cv):
    """Residual + analytic jacobians for one (or batched) observation;
    leading axes broadcast.

    R_kf [...,3,3], t_kf [...,3]: keyframe rotation/translation.
    x [...,3]: landmark (origin frame). uvd [...,3]: measurement.

    Returns (r [...,3], valid [...], Jp [...,3,6], Jl [...,3,3]) with the
    same validity semantics as :func:`limo_tpu_torch.residuals.reprojection`
    (|z_cam| < 0.01 ⇒ invalid row pair; depth row always valid, caller
    masks by d>0)."""
    y = _matvec(R_kf, x)                                  # R x
    p_veh = y + t_kf
    p_cam = _matvec(R_cv, p_veh) + t_cv
    z = p_cam[..., 2]
    valid = torch.abs(z) >= 0.01
    safe_z = torch.where(valid, z, torch.ones_like(z))
    inv_z = 1.0 / safe_z
    xy = p_cam[..., :2] * inv_z[..., None]
    uv_pred = focal[..., None] * xy + principal
    r_uv = uv_pred - uvd[..., :2]
    r_d = z - uvd[..., 2]
    r = torch.cat([r_uv, r_d[..., None]], -1)

    # ∂(uv,depth)/∂p_cam  [...,3,3]
    fz = focal * inv_z
    zero = torch.zeros_like(fz)
    row_u = torch.stack([fz, zero, -fz * xy[..., 0]], -1)
    row_v = torch.stack([zero, fz, -fz * xy[..., 1]], -1)
    row_d = torch.stack([zero, zero, torch.ones_like(fz)], -1)
    D = torch.stack([row_u, row_v, row_d], -2)

    # ∂p_cam/∂w = −2 R_cv [y]× ; ∂p_cam/∂dt = R_cv ; ∂p_cam/∂x = R_cv R_kf
    dp_dw = -2.0 * (R_cv @ skew(y))
    dp_dx = R_cv @ R_kf

    Jp = torch.cat([D @ dp_dw, D @ R_cv.expand(dp_dw.shape)], -1)  # [...,3,6]
    Jl = D @ dp_dx                                                 # [...,3,3]
    return r, valid, Jp, Jl


def rotations(poses):
    """R(q̂) [...,3,3] of each pose [...,7]: its normalised quaternion
    applied to the basis vectors as ``quaternion.qrot`` applies it,
    v + 2 (w u×v + u×(u×v)); fewer operations than ``qto_matrix``."""
    q = qnormalize(poses[..., :4])[..., None, :]
    w, u = q[..., :1], q[..., 1:]
    eye = torch.eye(3, dtype=poses.dtype, device=poses.device).expand(
        q.shape[:-2] + (3, 3))
    uv = torch.linalg.cross(u, eye)                       # row j: u × e_j
    return (eye + 2.0 * (w * uv + torch.linalg.cross(u, uv))).transpose(-1, -2)


def plane_normal_jac(n):
    """Unit normal n̂ = n/‖n‖ [...,3] of a stored normal and its retraction
    Jacobian ∂n̂/∂δn = (I − n̂n̂ᵀ)/‖n‖ [...,3,3] at δn = 0."""
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    nh = n / norm
    eye = torch.eye(3, dtype=n.dtype, device=n.device)
    return nh, (eye - nh[..., :, None] * nh[..., None, :]) / norm[..., None]


def groundplane_height_jac(R, t, plane, x):
    """Groundplane height r = n̂·(R x + t) + d of landmark x against the
    plane (n, d) of its keyframe (R, t), with n̂ = n/‖n‖; leading axes
    broadcast.

    Returns (r [...], J_pose [...,6] (w, dt), J_plane [...,4] (δn, δd),
    J_lm [...,3])."""
    norm = torch.linalg.vector_norm(plane[..., :3], dim=-1, keepdim=True)
    nh = plane[..., :3] / norm
    y = _matvec(R, x)                                     # R x
    p = y + t
    h = torch.sum(nh * p, -1, keepdim=True)               # n̂·p
    r = h[..., 0] + plane[..., 3]
    J_pose = torch.cat([2.0 * torch.linalg.cross(y, nh), nh], -1)
    J_plane = torch.cat([(p - nh * h) / norm, torch.ones_like(h)], -1)
    J_lm = _matvec(R.transpose(-1, -2), nh)
    return r, J_pose, J_plane, J_lm


def relative_translation(R1, t1, R0, t0):
    """u = translation(T1 ∘ T0⁻¹) = t1 − R1 R0ᵀ t0, with what its
    Jacobians need: returns (u, c = R1 R0ᵀ t0, R_rel = R1 R0ᵀ)."""
    R_rel = R1 @ R0.transpose(-1, -2)
    c = _matvec(R_rel, t0)
    return t1 - c, c, R_rel


def relative_translation_vjp(v, c, R_rel, t0):
    """vᵀ ∂u/∂(w1, dt1) and vᵀ ∂u/∂(w0, dt0) [...,6] of u =
    :func:`relative_translation`, for the row vector v [...,3]."""
    h = _matvec(R_rel.transpose(-1, -2), v)
    cross = torch.linalg.cross
    return (torch.cat([2.0 * cross(v, c), v], -1),
            torch.cat([2.0 * cross(t0, h), -h], -1))


def speed_vector_jac(R, t, t_before, vel_before, dt):
    """Speed-vector residual r = (R t_before + t)/dt − vel_before [...,3]
    (``residuals.speed_vector``: the translation of T ∘ T_before with
    T_before's translation t_before) and its Jacobian w.r.t. T's tangent
    [...,3,6]: −2 [R t_before]× / dt and I / dt."""
    y = _matvec(R, t_before)
    r = (y + t) / dt - vel_before
    S = skew(y)
    eye = torch.eye(3, dtype=y.dtype, device=y.device).expand(S.shape)
    return r, torch.cat([-2.0 * S, eye], -1) / dt
