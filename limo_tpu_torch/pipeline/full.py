"""The lidar front end of the images + lidar clouds → trajectory pipeline.

The reference package's ``limo_tpu/pipeline/full.py`` (``gamma_correct``,
``LimoPipelineConfig``, ``frontend_depth_plane``): the stages of the
reference launch graph (``launch/kitti_standalone.launch``) between the
camera/lidar inputs and the keyframe BA. The host-driven ``LimoPipeline``
is not part of the port yet; the fused pipeline (:mod:`.fused`) drives
these stages.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import LimoConfig
from ..frontend.groundplane import estimate_groundplane
from ..frontend.lidar_depth import (LidarDepthConfig, estimate_depths,
                                    ground_patch_depths)
from ..frontend.tracker import TrackerConfig
from ..geometry import pose as pose_ops
from ..geometry import quaternion as quat
from ..utils.precision import full_f32


def gamma_correct(img: np.ndarray, gamma: float = 1.2) -> np.ndarray:
    """Brightness normalization (image_preproc gamma nodelet,
    feature_matching.launch:9-15; gamma 1.2)."""
    return np.clip(img, 0.0, 1.0) ** (1.0 / gamma)


@full_f32
def frontend_depth_plane(cloud_veh, cloud_valid, Tcv7, uv, f, pp,
                         image_size, lidar_cfg, use_gp, gp_band):
    """The lidar front end of one frame: vehicle→camera transform, RANSAC
    groundplane, per-feature object depth, and the M-estimator ground-patch
    depth for features without one. Returns (depths [F], plane_veh [4] =
    (n, d) in the VEHICLE frame, plane_ok); the plane feeds the scan
    step's groundplane channel."""
    dtype = cloud_veh.dtype
    cloud_cam = pose_ops.apply(Tcv7, cloud_veh)
    d = estimate_depths(cloud_cam, cloud_valid, uv, f, pp, image_size,
                        lidar_cfg).depth
    plane = (torch.arange(4, device=d.device) == 2).to(dtype)
    plane_ok = torch.zeros((), dtype=torch.bool, device=d.device)
    if use_gp:
        gp = estimate_groundplane(cloud_veh, cloud_valid, z_band=gp_band)
        # plane vehicle→cam: n_cam = R n_veh; d_cam = d_veh − n_cam·t
        n_cam = quat.qrot(Tcv7[:4], gp.normal)
        d_cam = gp.distance - n_cam @ Tcv7[4:]
        gpd, gok = ground_patch_depths(cloud_cam, gp.inliers, uv, n_cam,
                                       d_cam, f, pp, image_size, lidar_cfg)
        d = torch.where(gp.ok & gok & (d < 0), gpd, d)
        plane = torch.cat([gp.normal, gp.distance[None]])
        plane_ok = gp.ok
    return d, plane, plane_ok


@dataclass(frozen=True)
class LimoPipelineConfig:
    limo: LimoConfig
    tracker: TrackerConfig
    lidar: LidarDepthConfig
    gamma: float = 1.2
    use_groundplane: bool = True
    gp_band: tuple = (-3.5, -1.0)   # ransac_plane_min/max_z (velodyne frame)
    # cloud padding capacity: a fixed capacity keeps every frame's shapes
    # the same; KITTI HDL-64 scans are ~120k points
    cloud_capacity: int = 1 << 17
