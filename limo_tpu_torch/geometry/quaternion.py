"""Quaternion algebra for bundle adjustment, in PyTorch.

Quaternions are stored ``(w, x, y, z)`` in the last axis, matching the
reference pose layout (``keyframe_bundle_adjustment/internal/definitions.hpp:23``:
poses are ``[qw, qx, qy, qz, tx, ty, tz]``).

All functions are shape-polymorphic over leading batch axes and dtype
polymorphic (f32 on the card, f64 for parity tests), and work under
``torch.func`` transforms (the solver takes Jacobians through them).

The box-plus retraction matches the reference's local parameterization
(``internal/local_parameterizations.hpp:47-92`` / Ceres
``QuaternionParameterization``): ``q' = exp(delta) * q`` with the *half angle*
convention ``exp(w) = (cos|w|, sin|w|/|w| * w)`` — a tangent vector of norm
``a`` rotates by angle ``2a``.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def qidentity(dtype=torch.float32, device=None):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def cross(a, b):
    """a × b over the last axis, broadcasting leading axes."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def qmul(q1, q2):
    """Hamilton product q1 ⊗ q2, (w,x,y,z) layout, batched on leading axes."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def qconj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def qinv(q):
    """Inverse for (possibly) non-unit quaternions."""
    return qconj(q) / torch.sum(q * q, dim=-1, keepdim=True)


def qnormalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def qrot(q, v):
    """Rotate vector(s) v by unit quaternion(s) q.

    Uses the expanded form ``v' = v + 2*w*(u×v) + 2*u×(u×v)`` (u = vector part)
    which is cheaper than two Hamilton products.
    """
    u = q[..., 1:]
    w = q[..., :1]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def qexp(w):
    """Tangent → quaternion, half-angle convention (|w| = theta/2).

    Matches Ceres' QuaternionParameterization ⊞ used by the reference
    (``local_parameterizations.hpp:57-76``). Taylor-guarded at 0 so that
    jacobians at delta=0 are exact (every Jacobian of the solver is taken
    there).
    """
    sq = torch.sum(w * w, dim=-1, keepdim=True)
    norm = torch.sqrt(torch.clamp_min(sq, _EPS))
    # sin(n)/n with series fallback for tiny n (keeps grad exact at 0).
    small = sq < 1e-12
    sinc = torch.where(small, 1.0 - sq / 6.0, torch.sin(norm) / norm)
    cos = torch.where(small, 1.0 - sq / 2.0, torch.cos(norm))
    return torch.cat([cos, sinc * w], dim=-1)


def qlog(q):
    """Unit quaternion → tangent (half-angle convention), inverse of qexp."""
    qn = qnormalize(q)
    # Make w >= 0 so the angle is in [0, pi].
    sign = torch.where(qn[..., :1] < 0, -1.0, 1.0).to(qn.dtype)
    qn = qn * sign
    w = torch.clamp(qn[..., :1], -1.0, 1.0)
    vec = qn[..., 1:]
    vn = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    angle = torch.atan2(vn, w)
    scale = torch.where(vn < 1e-9, 1.0 + (1.0 - w),
                        angle / torch.clamp_min(vn, _EPS))
    return scale * vec


def qboxplus(q, delta):
    """q' = exp(delta) ⊗ q  — left-multiplied retraction (reference ⊞)."""
    return qmul(qexp(delta), q)


def qangle(q0, q1):
    """Rotation angle (radians) between two unit quaternions.

    Mirrors ``calcQuaternionDiff`` (``definitions.cpp:104-111``).
    """
    d = qmul(qinv(q1), q0)
    d = qnormalize(d)
    w = torch.clamp(torch.abs(d[..., 0]), 0.0, 1.0)
    return 2.0 * torch.arccos(w)


def qfrom_axis_angle(axis, angle):
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    half = torch.as_tensor(angle, dtype=axis.dtype,
                           device=axis.device)[..., None] / 2.0
    return torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)


def qto_matrix(q):
    """Unit quaternion → 3x3 rotation matrix (batched)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def qfrom_matrix(m):
    """3x3 rotation matrix → unit quaternion (w,x,y,z), batched, branch-free:
    all four candidate quaternions, the one with the largest pivot kept."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidates, one per pivot; each 4*q_i^2 = 1 + 2*m_ii - tr (or 1+tr).
    def safe_sqrt(x):
        return torch.sqrt(torch.clamp_min(x, _EPS))

    qw = safe_sqrt(1.0 + tr) / 2.0
    c0 = torch.stack([qw, (m21 - m12) / (4 * qw), (m02 - m20) / (4 * qw), (m10 - m01) / (4 * qw)], -1)
    qx = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    c1 = torch.stack([(m21 - m12) / (4 * qx), qx, (m01 + m10) / (4 * qx), (m02 + m20) / (4 * qx)], -1)
    qy = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    c2 = torch.stack([(m02 - m20) / (4 * qy), (m01 + m10) / (4 * qy), qy, (m12 + m21) / (4 * qy)], -1)
    qz = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    c3 = torch.stack([(m10 - m01) / (4 * qz), (m02 + m20) / (4 * qz), (m12 + m21) / (4 * qz), qz], -1)

    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], -1)
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)  # [..., 4, 4]
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return qnormalize(q)
