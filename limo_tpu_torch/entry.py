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
(:func:`two_camera_window`), each with and without lidar depth.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import CapacityConfig, LimoConfig
from .geometry import pose as pose_ops
from .geometry.camera import CameraRig
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


def kernel_check_windows(device="cuda"):
    """Yield (name, (window, sel, rig, cfg)) for the kernel checks."""
    for depth in (True, False):
        yield (f"bench depth={depth}",
               make_problem(20, 1536, 12, 800, torch.float32,
                            with_depth=depth, seed=1, device=device))
        w, sel, rig = two_camera_window(with_depth=depth, device=device)
        yield f"C=2 L=1000 depth={depth}", (w, sel, rig, LimoConfig())
