"""Groundplane estimation from lidar points — batched RANSAC.

The reference package's ``limo_tpu/frontend/groundplane.py`` as PyTorch
ops. Its contract (``mono_lidar_fusion_parameters.yaml``, the
``ransac_plane`` block): the road plane from the lidar points with
z ∈ [−3.5, −1.0] m (vehicle frame), inlier threshold 0.2 m, 600 hypotheses,
a least-squares refinement on the winner's inliers.

The 600 hypotheses are drawn all at once from the reference's uint32 hash,
bit for bit, so each samples the same three points; inliers are counted in
one [P,600] comparison; the refinement's normal is the smallest eigenvector
of the weighted covariance (cyclic Jacobi, ``utils/eig3.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.quaternion import cross
from ..selection.landmark import norm, take
from ..utils import uint32
from ..utils.eig3 import smallest_eigvec3
from ..utils.precision import full_f32


class PlaneResult(NamedTuple):
    normal: torch.Tensor     # [3] unit, oriented to +z (up in vehicle frame)
    distance: torch.Tensor   # plane is n·p + d = 0
    inliers: torch.Tensor    # [N] bool
    ok: torch.Tensor         # bool


def _hash2(i, j):
    """The reference's uint32 hash of (i, j), on int64 in [0, 2^32)."""
    x = uint32.mul(i, 0x9E3779B9) ^ uint32.mul(j, 0x85EBCA6B)
    x = uint32.mul(x ^ (x >> 16), 0x7FEB352D)
    x = uint32.mul(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def fit_plane_lsq(points, w):
    """Weighted total-least-squares plane through points: the smallest
    eigenvector of the weighted covariance, oriented up."""
    wsum = torch.clamp_min(torch.sum(w), 1e-9)
    c = torch.sum(points * w[:, None], 0) / wsum
    d = (points - c) * w[:, None]
    cov = d.T @ d / wsum
    _, n = smallest_eigvec3(cov)
    n = n * torch.sign(n[2] + 1e-12)          # orient up
    return n, -torch.dot(n, c)


@full_f32
def estimate_groundplane(points, valid,
                         z_band=(-3.5, -1.0),
                         inlier_thres: float = 0.2,
                         num_hypotheses: int = 600,
                         min_inliers: int = 50,
                         seed: int = 0) -> PlaneResult:
    """RANSAC plane fit on candidate ground points (vehicle frame).

    points [N,3], valid [N]. Returns the plane with n·p + d = 0.
    """
    dev = points.device
    cand = valid & (points[:, 2] >= z_band[0]) & (points[:, 2] <= z_band[1])

    valid_idx = torch.argsort((~cand).to(torch.uint8), stable=True)
    n_valid = torch.clamp_min(cand.sum(), 1)
    hyp = torch.arange(num_hypotheses, device=dev)
    pick = torch.arange(3, device=dev)
    r = _hash2((hyp[:, None] + seed * 31337) & uint32.MASK, pick[None, :])
    sample = valid_idx[r % n_valid]                              # [H,3]
    p = points[sample]                                           # [H,3,3]

    n = cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])              # [H,3]
    nn = norm(n)[:, None]
    degenerate = nn[:, 0] < 1e-9
    n = n / torch.clamp_min(nn, 1e-12)
    d = -torch.sum(n * p[:, 0], -1)                              # [H]

    dist = torch.abs(points @ n.T + d[None, :])                  # [N,H]
    inl = (dist < inlier_thres) & cand[:, None]
    counts = inl.sum(0) * (~degenerate)
    best = torch.argmax(counts)

    # refinement on the winning inlier set
    n_ref, d_ref = fit_plane_lsq(points, take(inl, best, 1).to(points.dtype))
    inliers = (torch.abs(points @ n_ref + d_ref) < inlier_thres) & cand
    return PlaneResult(normal=n_ref, distance=d_ref, inliers=inliers,
                       ok=inliers.sum() >= min_inliers)
