"""Analytic jacobians of the observation residuals.

These closed forms are what the CUDA assembly kernels compute in registers
(``csrc/assemble.cu``), and the plain PyTorch versions of those kernels
(:mod:`limo_tpu_torch.solver.cuda_assemble`) are built from them. They are
exact: the reference package tests them against autodiff to machine
precision, and the port's parity tests hold the assembled blocks against
the reference's autodiff path in f64.

Derivation (conventions of :mod:`limo_tpu_torch.geometry.pose`):
  p_veh = R(q) x + t           (pose keyframe←origin, ⊞: q'=exp(w)q, t'=t+dt)
  p_cam = R_cv p_veh + t_cv    (extrinsics constant)
  uv    = f * (p_x, p_y)/p_z + pp ;  depth residual = p_z − d

  ∂p_veh/∂w  = −2 [R(q) x]×   (half-angle tangent: exp(w) rotates by 2|w|)
  ∂p_veh/∂dt = I
  ∂p_veh/∂x  = R(q)
  ∂p_cam/∂·  = R_cv ∂p_veh/∂·
  ∂uv/∂p_cam = f/z [[1,0,−x/z],[0,1,−y/z]] ;  ∂depth/∂p_cam = (0,0,1)
"""

from __future__ import annotations

import torch


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
