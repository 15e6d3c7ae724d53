"""Full Limo2 pipeline: images + lidar clouds → trajectory.

The reference package's ``limo_tpu/pipeline/full.py``: the stages of the
reference launch graph (``launch/kitti_standalone.launch``) between the
camera/lidar inputs and the keyframe BA — gamma-normalized image → feature
tracking → lidar depth per feature → (optional) semantic labels →
groundplane estimation → keyframe BA. :class:`LimoPipeline` is the
host-driven engine (the reference's online node, one call per frame);
the fused pipeline (:mod:`.fused`) drives the same lidar front end
(:func:`frontend_depth_plane`) on the device.
"""

from __future__ import annotations

import contextlib
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..config import LimoConfig
from ..frontend.groundplane import estimate_groundplane
from ..frontend.lidar_depth import (LidarDepthConfig, estimate_depths,
                                    ground_patch_depths)
from ..frontend.semantics import attach_labels
from ..frontend.tracker import FeatureTracker, TrackerConfig
from ..geometry import pose as pose_ops
from ..geometry import quaternion as quat
from ..geometry.camera import CameraRig
from ..utils.precision import full_f32
from ..utils.transfer import numpy_float, upload
from .odometry import FrameResult, LidarOdometry


def gamma_correct(img: np.ndarray, gamma: float = 1.2) -> np.ndarray:
    """Brightness normalization (image_preproc gamma nodelet,
    feature_matching.launch:9-15; gamma 1.2)."""
    return np.clip(img, 0.0, 1.0) ** (1.0 / gamma)


def _gamma_u8_device(img_u8, gamma: float, dtype=torch.float32):
    """uint8 → gamma-corrected float on the device: the raw bytes go up,
    4× less traffic than a host-side float conversion."""
    return (img_u8.to(dtype) / 255.0) ** (1.0 / gamma)


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


def _frontend_depth(cloud_veh, cloud_valid, Tcv7, uv, f, pp, image_size,
                    lidar_cfg, use_gp, gp_band):
    """The per-feature depths of :func:`frontend_depth_plane` alone (the
    host-driven pipeline's depth hook)."""
    d, _, _ = frontend_depth_plane(cloud_veh, cloud_valid, Tcv7, uv, f, pp,
                                   image_size, lidar_cfg, use_gp, gp_band)
    return d


class LimoPipeline:
    """End-to-end online pipeline. Per frame:
    ``process(stamp, image, cloud_veh=None, label_image=None)``.

    cloud_veh: lidar points in the *vehicle* frame [N,3] (callers transform
    from the sensor frame with the calibration; see io.kitti). ``device``:
    where the numeric work runs (the card unless the caller asks for the
    CPU). ``timer``: optional per-stage wall timing, any object whose
    ``stage(name)`` is a context manager.
    """

    def __init__(self, rig: CameraRig, cfg: Optional[LimoPipelineConfig] = None,
                 dtype=torch.float32, timer=None, device="cuda"):
        if cfg is None:
            cfg = LimoPipelineConfig(limo=LimoConfig(), tracker=TrackerConfig(),
                                     lidar=LidarDepthConfig())
        self.cfg = cfg
        self.rig = rig
        self.dtype = dtype
        self.device = torch.device(device)
        # the image path runs in the pipeline's float type (the reference
        # package tracks in float32 whatever it is): a float32 pipeline is
        # the reference's, a float64 one is float64 throughout
        self.tracker = FeatureTracker(cfg.tracker, device=device, dtype=dtype)
        self.odometry = LidarOdometry(rig, cfg.limo, dtype, device)
        self._image_size: Optional[tuple] = None
        self._warned_cloud_cap = False
        self.timer = timer

    def _stage(self, name):
        return self.timer.stage(name) if self.timer else \
            contextlib.nullcontext()

    def _pad_cloud(self, cloud_veh):
        """The cloud padded to the fixed capacity, with its valid mask."""
        cap = self.cfg.cloud_capacity
        if cloud_veh.shape[0] > cap and not self._warned_cloud_cap:
            self._warned_cloud_cap = True
            warnings.warn(
                f"lidar scan has {cloud_veh.shape[0]} points; "
                f"truncating to cloud_capacity={cap} — raise "
                "LimoPipelineConfig.cloud_capacity to keep the tail")
        np_dt = numpy_float(self.dtype)
        pts = np.asarray(cloud_veh[:, :3], np_dt)[:cap]
        n = pts.shape[0]
        buf = np.zeros((cap, 3), np_dt)
        buf[:n] = pts
        vmask = np.zeros((cap,), bool)
        vmask[:n] = True
        return buf, vmask

    def process(self, stamp: float, image: np.ndarray,
                cloud_veh: Optional[np.ndarray] = None,
                label_image: Optional[np.ndarray] = None) -> FrameResult:
        if self._image_size is None:
            self._image_size = (image.shape[1], image.shape[0])
        host = [image if image.dtype == np.uint8
                else gamma_correct(image.astype(np.float32), self.cfg.gamma)]
        has_cloud = cloud_veh is not None and cloud_veh.size > 0
        if has_cloud:
            with self._stage("cloud_pad"):
                host += list(self._pad_cloud(cloud_veh))
        # the frame's image and cloud go up in one copy
        dev = upload(host, self.device)
        with self._stage("preprocess"):
            img = (_gamma_u8_device(dev[0], self.cfg.gamma, self.dtype)
                   if image.dtype == np.uint8 else dev[0])
        rig, dtype = self.rig, self.dtype

        def depth_fn(uv):
            if not has_cloud:
                return torch.full(uv.shape[:1], -1.0, dtype=dtype,
                                  device=uv.device)
            with self._stage("lidar_depth"):
                # road features get the M-estimator local ground patch over
                # the RANSAC inliers (reference
                # plane_estimator_use_mestimator, the evaluated-best method)
                return _frontend_depth(
                    dev[1], dev[2], rig.T_cam_veh[0].to(dtype), uv.to(dtype),
                    rig.focal[0].to(dtype), rig.principal[0].to(dtype),
                    self._image_size, self.cfg.lidar,
                    self.cfg.use_groundplane, tuple(self.cfg.gp_band))

        with self._stage("tracker"):
            self.tracker.process(stamp, img, depth_fn=depth_fn)
        with self._stage("tracklets"):
            tl = self.tracker.tracklets(
                window=self.cfg.limo.capacity.max_keyframes)
            if label_image is not None:
                tl = attach_labels(tl, label_image, device=self.device)
        with self._stage("odometry"):
            return self.odometry.process_frame(stamp, tl)

    def poses_kitti(self) -> np.ndarray:
        return self.odometry.poses_kitti()
