"""Pinhole camera model, batched + masked.

Reference: ``keyframe_bundle_adjustment/internal/definitions.hpp:93-124`` —
single focal length, principal point, extrinsic pose_camera_vehicle
(camera ← vehicle). The z-guard reproduces the reference's projection validity
check (``cost_functors_ceres.hpp:78-82``: |z| < 0.01 ⇒ invalid residual).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import pose as pose_ops

Z_GUARD = 0.01


class CameraRig(NamedTuple):
    """A rig of C pinhole cameras attached to the vehicle frame.

    focal:        [C]   single focal length per camera (reference style)
    principal:    [C,2] principal point (cx, cy)
    T_cam_veh:    [C,7] pose camera ← vehicle (extrinsics)
    """

    focal: torch.Tensor
    principal: torch.Tensor
    T_cam_veh: torch.Tensor

    @property
    def num_cameras(self) -> int:
        return self.focal.shape[0]

    @staticmethod
    def single(focal, cx, cy, T_cam_veh=None, dtype=torch.float32,
               device="cuda"):
        if T_cam_veh is None:
            T_cam_veh = pose_ops.identity(dtype, device)
        return CameraRig(
            focal=torch.tensor([focal], dtype=dtype, device=device),
            principal=torch.tensor([[cx, cy]], dtype=dtype, device=device),
            T_cam_veh=torch.as_tensor(T_cam_veh, dtype=dtype,
                                      device=device)[None, :],
        )


def project(point_cam, focal, principal):
    """Project camera-frame point(s) → (uv [..,2], valid [..] bool).

    Invalid when |z| < Z_GUARD (reference ``cost_functors_ceres.hpp:78``).
    The division is guarded so gradients stay finite on masked entries.
    """
    z = point_cam[..., 2]
    valid = torch.abs(z) >= Z_GUARD
    safe_z = torch.where(valid, z, torch.ones_like(z))
    xy = point_cam[..., :2] / safe_z[..., None]
    uv = focal[..., None] * xy + principal
    return uv, valid


def backproject(uv, depth, focal, principal):
    """(u,v,z) → camera-frame 3D point. Inverse of project for z>0."""
    xy = (uv - principal) / focal[..., None]
    z = depth[..., None]
    return torch.cat([xy * z, z], dim=-1)


def viewing_ray(uv, focal, principal):
    """Unit viewing ray in camera frame for pixel(s) uv.

    Mirrors ``Camera::getViewingRay`` (``definitions.cpp:44-53``). The norm
    is the square root of the sum of squares, as the reference package
    forms it."""
    r = backproject(uv, torch.ones_like(uv[..., 0]), focal, principal)
    return r / torch.sqrt(torch.sum(r * r, dim=-1, keepdim=True))
