"""Pure-numpy pose and quaternion arithmetic of the traffic generator.

A frozen copy of the port's ``geometry/pose_host.py``, so that the
generator (``synthetic.py``) gives the same arrays, bit for bit, as the
program's own generator: ``p = [qw,qx,qy,qz,tx,ty,tz]``,
``apply(p, x) = R(q) x + t``, float64 throughout.
"""

from __future__ import annotations

import numpy as np


def qnormalize(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def qconj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def qmul(q1, q2):
    w1, x1, y1, z1 = np.moveaxis(q1, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(q2, -1, 0)
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], -1)


def qrot(q, v):
    """Rotate v by unit quaternion q (broadcasts over leading dims)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def qangle(q0, q1):
    """Rotation angle of q1⁻¹ ⊗ q0 (calcQuaternionDiff equivalent)."""
    d = qmul(qconj(qnormalize(q1)), qnormalize(q0))
    w = np.clip(np.abs(d[..., 0]), -1.0, 1.0)
    return 2.0 * np.arccos(w)


def qto_matrix(q):
    w, x, y, z = np.moveaxis(qnormalize(q), -1, 0)
    row = lambda a, b, c: np.stack([a, b, c], -1)
    return np.stack([
        row(1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        row(2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        row(2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    ], -2)


def apply(p, x):
    """p [...,7] applied to x [...,3]; a single pose broadcasts over a
    batch of points (numpy broadcasting handles [4] q against [N,3] v)."""
    return qrot(p[..., :4], x) + p[..., 4:]


def compose(p1, p2):
    q = qmul(p1[..., :4], p2[..., :4])
    t = qrot(p1[..., :4], p2[..., 4:]) + p1[..., 4:]
    return np.concatenate([q, t], -1)


def inverse(p):
    qi = qconj(qnormalize(p[..., :4]))
    return np.concatenate([qi, -qrot(qi, p[..., 4:])], -1)


def relative(p1, p0):
    return compose(p1, inverse(p0))


def translation(p):
    return p[..., 4:]


def to_matrix(p):
    R = qto_matrix(p[..., :4])
    t = p[..., 4:]
    top = np.concatenate([R, t[..., :, None]], -1)
    bottom = np.broadcast_to(np.array([0.0, 0.0, 0.0, 1.0]),
                             p.shape[:-1] + (1, 4))
    return np.concatenate([top, bottom], -2)


def qfrom_matrix(m):
    """3x3 rotation matrix → unit quaternion (w,x,y,z), batched — the numpy
    mirror of :func:`limo_tpu_torch.geometry.quaternion.qfrom_matrix` (same
    all-candidates + largest-pivot selection, so host and device agree)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return np.sqrt(np.maximum(x, 1e-12))

    qw = safe_sqrt(1.0 + tr) / 2.0
    c0 = np.stack([qw, (m21 - m12) / (4 * qw), (m02 - m20) / (4 * qw),
                   (m10 - m01) / (4 * qw)], -1)
    qx = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    c1 = np.stack([(m21 - m12) / (4 * qx), qx, (m01 + m10) / (4 * qx),
                   (m02 + m20) / (4 * qx)], -1)
    qy = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    c2 = np.stack([(m02 - m20) / (4 * qy), (m01 + m10) / (4 * qy), qy,
                   (m12 + m21) / (4 * qy)], -1)
    qz = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    c3 = np.stack([(m10 - m01) / (4 * qz), (m02 + m20) / (4 * qz),
                   (m12 + m21) / (4 * qz), qz], -1)

    pivots = np.stack([tr, m00 - m11 - m22, -m00 + m11 - m22,
                       -m00 - m11 + m22], -1)
    best = np.argmax(pivots, axis=-1)
    cands = np.stack([c0, c1, c2, c3], axis=-2)               # [..., 4, 4]
    q = np.take_along_axis(cands, best[..., None, None],
                           axis=-2)[..., 0, :]
    return qnormalize(q)


def from_matrix(m):
    """[...,4,4] rigid transform → pose [...,7]."""
    return np.concatenate([qfrom_matrix(m[..., :3, :3]), m[..., :3, 3]], -1)
