"""The port's flagship step and its fixture.

:func:`make_problem` builds the synthetic KITTI-scale window the reference
package's ``__graft_entry__._make_problem`` builds — the same numpy draws
in the same order, so the same seed gives the same arrays — as tensors on
the card. ``make_problem(20, 1536, 12, 800, torch.float32, seed=1)`` is the
trimmed-solve fixture of ``bench.py`` and ``chip_smoke.py``: 20 keyframe
slots × 1536 landmark slots × 1 camera, 12 keyframes and 800 landmarks in
use, lidar depth on every landmark.

:func:`kernel_check_windows` lists the windows on which the kernels are
held against their plain versions: the bench window and a 2-camera window
(:func:`two_camera_window`), each with and without lidar depth, and a
window of 40 keyframe slots whose keyframes in use sit in slots 28-39
(:func:`rolled_window`).

:func:`scan_drive` builds the scan-odometry drive at full width: the
default ``LimoConfig()`` capacity (20 keyframe slots × 1536 landmark slots
× 1 camera) on a synthetic 10 m/s KITTI-like world, for
:func:`limo_tpu_torch.pipeline.scan_odometry.run_sequence`.

:func:`fused_drive` builds the fused images + clouds drive at full width,
the reference package's flagship fused configuration, for
:func:`limo_tpu_torch.pipeline.fused.run_fused`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import (CapacityConfig, LandmarkSelectionConfig, LimoConfig,
                     PriorConfig)
from .frontend.lidar_depth import LidarDepthConfig
from .frontend.tracker import TrackerConfig
from .geometry import pose as pose_ops
from .geometry.camera import CameraRig
from .pipeline.evaluation import make_km_rendered_world
from .pipeline.full import LimoPipelineConfig
from .pipeline.render import SequenceRenderer
from .pipeline.synthetic import dense_tracks, make_world
from .state import Selection, Window, empty_window


def make_problem(K_cap, L_cap, K_used, L_used, dtype=torch.float32,
                 with_depth=True, seed=0, device="cuda"):
    """Synthetic window + selection + rig + config: (window, sel, rig, cfg)."""
    rng = np.random.default_rng(seed)
    cfg = LimoConfig(capacity=CapacityConfig(
        max_keyframes=K_cap, max_landmarks=L_cap, max_cameras=1))
    rig = CameraRig.single(600.0, 300.0, 200.0, dtype=dtype, device=device)
    w = empty_window(cfg.capacity, dtype, device)
    K, L, C = w.K, w.L, w.C

    # ground truth in float64 on the host
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64)
    gt = [np.array([1.0, 0, 0, 0, 0, 0, 0])]
    for _ in range(1, K_used):
        d = np.zeros(7)
        d[0] = np.cos(0.005)
        d[3] = np.sin(0.005)
        d[4:] = [-0.05, 0.0, -1.2]
        gt.append(pose_ops.compose(f64(gt[-1]), f64(d)).numpy())
    gt = np.stack(gt)
    lms = rng.uniform(-1, 1, (L_used, 3)) * np.array([20.0, 10.0, 8.0]) \
        + np.array([0, 0, 35.0])
    obs = np.zeros((L, K, C, 3))
    obs[..., 2] = -1.0
    msk = np.zeros((L, K, C), bool)
    for k in range(K_used):
        pc = pose_ops.apply(f64(gt[k]), f64(lms)).numpy()
        uv = 600 * pc[:, :2] / pc[:, 2:3] + np.array([300.0, 200.0])
        obs[:L_used, k, 0, :2] = uv + rng.normal(0, 0.5, uv.shape)
        if with_depth:
            obs[:L_used, k, 0, 2] = pc[:, 2] + rng.normal(0, 0.05, L_used)
        msk[:L_used, k, 0] = True
    poses0 = np.tile(np.array([1.0, 0, 0, 0, 0, 0, 0]), (K, 1))
    poses0[:K_used] = gt
    poses0[2:K_used, 4:] += rng.normal(0, 0.1, (max(K_used - 2, 0), 3))
    lms0 = np.zeros((L, 3))
    lms0[:L_used] = lms + rng.normal(0, 0.3, (L_used, 3))

    dev = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device=device)
    stamps, kf_valid = w.stamps.clone(), w.kf_valid.clone()
    stamps[:K_used] = torch.arange(K_used, dtype=stamps.dtype,
                                   device=device) * 0.4
    kf_valid[:K_used] = True
    fix_pose, fix_scale = w.fix_pose.clone(), w.fix_scale.clone()
    fix_pose[0] = True
    fix_scale[1] = True
    lm_valid, lm_has_depth = w.lm_valid.clone(), w.lm_has_depth.clone()
    lm_valid[:L_used] = True
    lm_has_depth[:L_used] = bool(with_depth)
    lm_id = w.lm_id.clone()
    lm_id[:L_used] = torch.arange(L_used, dtype=torch.int32, device=device)
    w = w._replace(
        stamps=stamps, poses=dev(poses0), kf_valid=kf_valid,
        fix_pose=fix_pose, fix_scale=fix_scale, lm_pos=dev(lms0),
        lm_valid=lm_valid, lm_has_depth=lm_has_depth, lm_id=lm_id,
        obs=dev(obs), obs_mask=dev(msk, torch.bool))
    return w, _all_selected(w), rig, cfg


def _all_selected(w: Window) -> Selection:
    """Every valid landmark selected; no groundplane or scale residuals."""
    L, dtype, device = w.L, w.poses.dtype, w.poses.device
    scalar = lambda v, dt: torch.full((), v, dtype=dt, device=device)
    return Selection(
        lm_selected=w.lm_valid.clone(),
        gp_kf=torch.zeros((L,), dtype=torch.int32, device=device),
        gp_weight=torch.zeros((L,), dtype=dtype, device=device),
        scale_kf0=scalar(0, torch.int32), scale_kf1=scalar(1, torch.int32),
        scale_target=scalar(0.0, dtype), scale_weight=scalar(0.0, dtype),
        plane_dist_fixed=scalar(False, torch.bool))


def two_camera_window(K=6, L=1000, with_depth=True, seed=5, device="cuda"):
    """A float32 window of K keyframes × L landmarks × 2 cameras for kernel
    checks: rotated keyframes, a rotated and offset second camera, label
    weights, lidar depth on ~70 % of the landmarks (none without
    ``with_depth``) and ~80 % of the observation slots set. L need not be a
    multiple of anything. The observations are random pixels, not
    projections: large residuals stress the robust weights. Returns
    (window, sel, rig)."""
    rng = np.random.default_rng(seed)
    C = 2
    q = np.concatenate([np.ones((K, 1)), rng.normal(0, 0.05, (K, 3))], 1)
    poses = np.concatenate([q / np.linalg.norm(q, axis=1, keepdims=True),
                            rng.normal(0, 1.0, (K, 3))], 1)
    lms = rng.uniform(-1, 1, (L, 3)) * [12.0, 7.0, 5.0] + [0.0, 0.0, 28.0]
    obs = np.concatenate([rng.uniform(0, 600, (L, K, C, 2)),
                          rng.uniform(-5, 40, (L, K, C, 1))], -1)
    has_depth = (rng.uniform(size=L) > 0.3) & bool(with_depth)
    dev = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt,
                                                      device=device)
    w = empty_window(CapacityConfig(K, L, C), torch.float32, device)
    w = w._replace(
        poses=dev(poses), kf_valid=dev(np.ones(K, bool), torch.bool),
        lm_pos=dev(lms), lm_valid=dev(np.ones(L, bool), torch.bool),
        lm_has_depth=dev(has_depth, torch.bool),
        lm_weight=dev(rng.uniform(0.5, 1.0, L)), obs=dev(obs),
        obs_mask=dev(rng.uniform(size=(L, K, C)) > 0.2, torch.bool))
    qc = np.array([0.999, 0.02, -0.03, 0.01])
    rig = CameraRig(
        focal=dev([600.0, 500.0]),
        principal=dev([[300.0, 200.0], [310.0, 190.0]]),
        T_cam_veh=dev([[1.0, 0, 0, 0, 0, 0, 0],
                       list(qc / np.linalg.norm(qc)) + [-0.5, 0.1, 0.2]]))
    return w, _all_selected(w), rig


def rolled_window(device="cuda"):
    """``make_problem(40, 999, 12, 700, float32, seed=3)`` with every
    keyframe-indexed field rolled by 28 slots: the 12 keyframes in use sit
    in slots 28-39, so slots 32 and above hold observations, and L = 999
    fills no tile of landmarks. 12 keyframes, as in the bench window: over
    20 frames the drive brings landmarks to 4 m, where some U entries are
    sums of far larger terms, and float32 rounding alone exceeds the
    kernels' tolerance (tests/test_torch_cuda.py). Returns
    (window, sel, rig, cfg)."""
    w, sel, rig, cfg = make_problem(40, 999, 12, 700, torch.float32, seed=3,
                                    device=device)
    kf_fields = ("stamps", "poses", "kf_valid", "fix_pose", "fix_scale",
                 "planes", "plane_valid")
    w = w._replace(**{f: torch.roll(getattr(w, f), 28, 0) for f in kf_fields},
                   obs=torch.roll(w.obs, 28, 1),
                   obs_mask=torch.roll(w.obs_mask, 28, 1))
    return w, sel, rig, cfg


def kernel_check_windows(device="cuda"):
    """Yield (name, (window, sel, rig, cfg)) for the kernel checks."""
    for depth in (True, False):
        yield (f"bench depth={depth}",
               make_problem(20, 1536, 12, 800, torch.float32,
                            with_depth=depth, seed=1, device=device))
        w, sel, rig = two_camera_window(with_depth=depth, device=device)
        yield f"C=2 L=1000 depth={depth}", (w, sel, rig, LimoConfig())
    yield "K=40 (slots 28-39) L=999", rolled_window(device)


def scan_drive(num_frames=60, seed=3, with_depth=True, dtype=torch.float32,
               device="cuda"):
    """The full-width scan drive: ``make_world(num_frames, seed=seed)`` with
    its defaults (600 landmarks, 200 ground points, 10 m/s, 10 Hz), tracked
    into ``dense_tracks(world, 1536, with_depth, seed=seed + 1)`` under
    ``LimoConfig()``. Returns (stamps [F], uvd [F,1536,3], valid [F,1536] as
    numpy, rig on ``device``, cfg, world)."""
    world = make_world(num_frames, seed=seed)
    cfg = LimoConfig()
    stamps, uvd, valid = dense_tracks(world, cfg.capacity.max_landmarks,
                                      with_depth=with_depth, seed=seed + 1)
    on = lambda a: torch.as_tensor(np.asarray(a)[None], dtype=dtype,
                                   device=device)
    rig = CameraRig(focal=on(world.focal), principal=on(world.principal),
                    T_cam_veh=on(world.T_cam_veh))
    return stamps, uvd, valid, rig, cfg, world


def fused_drive(num_frames=200, seed=11, device="cuda"):
    """The full-width fused drive, as the reference package's
    ``evaluation.evaluate_rendered_long_drive`` builds it: ``LimoConfig()``
    (20 keyframe slots × 1536 landmark slots × 1 camera) with a 1.65 m
    camera height and a 12 m/s default speed; 384 features (border 8, NMS
    radius 5); the default lidar depth; the groundplane on; clouds padded
    to 16384 points; labels on. The world is ``make_km_rendered_world(
    num_frames, seed=seed)`` (a ramp, a standstill and two turns, scaled to
    ``num_frames``) rendered at 512 × 192, f = 450, clouds drawn from
    ``np.random.default_rng(seed)``. Returns (stamps [F], images_u8
    [F,H,W], clouds (a list of [Ni,3] vehicle-frame scans), label_images
    [F,H,W] uint8, rig on ``device``, cfg, pcfg, world)."""
    world, _ = make_km_rendered_world(num_frames, seed=seed)
    cfg = LimoConfig(
        landmark_selection=dataclasses.replace(
            LandmarkSelectionConfig(), height_over_ground=1.65),
        prior=dataclasses.replace(PriorConfig(), default_speed=12.0))
    pcfg = LimoPipelineConfig(
        limo=cfg,
        tracker=TrackerConfig(max_features=384, border=8, nms_radius=5),
        lidar=LidarDepthConfig(), use_groundplane=True,
        cloud_capacity=16384)
    rend = SequenceRenderer(world)
    rng = np.random.default_rng(seed)
    W, H = world.image_size
    images = np.empty((num_frames, H, W), np.uint8)
    labels = np.empty_like(images)
    clouds = []
    for i in range(num_frames):
        img, lab = rend.frame(i)
        images[i] = (img * 255).astype(np.uint8)
        labels[i] = lab
        clouds.append(rend.cloud(i, rng))
    rig = CameraRig.single(world.focal, world.principal[0],
                           world.principal[1], T_cam_veh=world.T_cam_veh,
                           device=device)
    return (world.stamps[:num_frames], images, clouds, labels, rig, cfg,
            pcfg, world)
