"""Batched linear-midpoint triangulation.

Reference: ``keyframe_bundle_adjustment/internal/triangulator.hpp:51-75`` —
minimize sum_i || (I - r_i r_i^T)(p - c_i) ||^2 over world-frame ray directions
r_i and camera centers c_i; accumulate A = sum(I - r r^T), b = sum((I - r r^T) c)
and solve the 3x3 system.

One product over the observation axis and a batched 3×3 solve; no
per-landmark loop. The solves use ``torch.linalg.solve_ex``: plain
``torch.linalg.solve`` checks for singular systems on the host, which waits
for the card.
"""

from __future__ import annotations

import torch


def _solve_guarded(P, centers, ok_extra):
    """(points, ok) from the masked projectors P [...,N,3,3]."""
    eye = torch.eye(3, dtype=P.dtype, device=P.device)
    A = torch.sum(P, dim=-3)
    b = torch.sum(torch.einsum("...nij,...nj->...ni", P, centers), dim=-2)
    # Tikhonov-guard the solve so masked-out landmarks don't produce NaNs;
    # validity is reported separately via the determinant.
    ok = (torch.abs(torch.linalg.det(A)) > 1e-9) & ok_extra
    A_safe = A + (1.0 - ok.to(P.dtype))[..., None, None] * eye
    points = torch.linalg.solve_ex(A_safe, b[..., None])[0][..., 0]
    return points, ok


def triangulate_rays(rays, centers, mask=None):
    """Midpoint triangulation of one landmark from many rays.

    rays:    [N,3] unit ray directions in world/origin frame
    centers: [N,3] camera centers in world/origin frame
    mask:    [N] optional bool validity mask

    Returns (point [3], ok bool). ``ok`` is False when the system is rank
    deficient (near-parallel rays; a single ray always is).
    """
    if mask is None:
        mask = torch.ones(rays.shape[:-1], dtype=torch.bool, device=rays.device)
    eye = torch.eye(3, dtype=rays.dtype, device=rays.device)
    # P_i = I - r_i r_i^T  (projector onto plane orthogonal to the ray)
    P = (eye - rays[..., :, None] * rays[..., None, :]) \
        * mask.to(rays.dtype)[..., None, None]
    return _solve_guarded(P, centers, torch.ones_like(mask[..., 0]))


def triangulate_batch(rays, centers, mask):
    """Triangulate L landmarks from up to N observations each.

    rays:    [L,N,3], centers: [L,N,3], mask: [L,N]
    Returns (points [L,3], ok [L]): ``ok`` also needs two rays or more.
    """
    eye = torch.eye(3, dtype=rays.dtype, device=rays.device)
    P = (eye - rays[..., :, None] * rays[..., None, :]) \
        * mask.to(rays.dtype)[..., None, None]
    return _solve_guarded(P, centers, torch.sum(mask, dim=-1) >= 2)
