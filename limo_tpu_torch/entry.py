"""The port's flagship step and its fixture.

:func:`make_problem` builds the synthetic KITTI-scale window the reference
package's ``__graft_entry__._make_problem`` builds — the same numpy draws
in the same order, so the same seed gives the same arrays — as tensors on
the card. ``make_problem(20, 1536, 12, 800, torch.float32, seed=1)`` is the
trimmed-solve fixture of ``bench.py`` and ``chip_smoke.py``: 20 keyframe
slots × 1536 landmark slots × 1 camera, 12 keyframes and 800 landmarks in
use, lidar depth on every landmark.

:func:`speed_regularizer` gives a window's windowed motion-only solve
(``run_lm(pose_only=True, speed_reg=...)``) its constant-velocity term.

:func:`kernel_check_windows` lists the windows on which the kernels are
held against their plain versions: the bench window and a 2-camera window
(:func:`two_camera_window`), each with and without lidar depth, and a
window of 40 keyframe slots whose keyframes in use sit in slots 28-39
(:func:`rolled_window`).

:func:`scan_drive` builds the scan-odometry drive at full width: the
default ``LimoConfig()`` capacity (20 keyframe slots × 1536 landmark slots
× 1 camera) on a synthetic 10 m/s KITTI-like world, for
:func:`limo_tpu_torch.pipeline.scan_odometry.run_sequence`.

:func:`labelled_scan_drive` is the same drive with vegetation and moving
cars beside its landmarks and ground points, tracked with their semantic
labels.

:func:`fused_drive` builds the fused images + clouds drive at full width,
the reference package's flagship fused configuration, for
:func:`limo_tpu_torch.pipeline.fused.run_fused`.

:func:`kitti_host_drive` writes the reference package's rendered KITTI-layout
drive (its host-engine gate's world) to disk and returns that gate's
configuration, for :func:`limo_tpu_torch.pipeline.evaluation.
evaluate_kitti_sequence`.

:func:`entry` is the flagship step as the reference package's
``__graft_entry__.entry`` gives it, and :func:`dryrun_multichip` its
multi-device check: N ranks run the landmark-sharded solve on tiny batched
shapes, at the bench scale against the unsharded solve, and a sequence
fleet through the multi-process helpers. From the command line::

    python -m limo_tpu_torch.entry                   # entry() once
    python -m limo_tpu_torch.entry dryrun N [--device cpu] [--backend nccl]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

from .config import (CapacityConfig, LandmarkSelectionConfig, LimoConfig,
                     PriorConfig)
from .frontend.lidar_depth import LidarDepthConfig
from .frontend.tracker import TrackerConfig
from .geometry import pose as pose_ops
from .geometry.camera import CameraRig
from .pipeline.evaluation import make_km_rendered_world, rendered_drive_config
from .parallel import (gather_selection, gather_window,
                       host_local_to_global, make_mesh, make_sharded_solver,
                       process_local_batch, shard_selection, shard_window,
                       spawn)
from .parallel.multihost import mesh_device
from .pipeline import scan_odometry as so
from .pipeline.full import LimoPipelineConfig
from .pipeline.render import SequenceRenderer, write_kitti_sequence
from .pipeline.synthetic import dense_tracks, make_world
from .solver import solve_trimmed
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


def speed_regularizer(w: Window):
    """``speed_reg`` of a windowed motion-only solve, ``(kf_index,
    pose_origin_before, vel_before, dt, weight)``: the newest active
    keyframe (read on the host), the inverse of its pose before the solve,
    a velocity of (0.2, -0.1, 0.5) m/s, dt = 0.1 s and weight 0.5."""
    newest = torch.where(w.kf_valid, w.stamps,
                         torch.full_like(w.stamps, -torch.inf))
    kf = int(torch.argmax(newest))
    vel = torch.tensor([0.2, -0.1, 0.5], dtype=w.poses.dtype)
    return kf, pose_ops.inverse(w.poses[kf]), vel.to(w.poses.device), 0.1, 0.5


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


def labelled_scan_drive(num_frames=12, seed=3, device="cuda"):
    """:func:`scan_drive`'s world with 60 vegetation points (cityscapes
    label 21) and 40 points on moving cars (label 26) beside its landmarks
    (label −2, none) and ground points (7), tracked into 1536 rows with
    their labels. Returns (stamps [F], uvd [F,1536,3], valid [F,1536],
    labels [F,1536] int32 as numpy, float32 rig on ``device``, cfg,
    world)."""
    world = make_world(num_frames, seed=seed, n_shrubbery=60, n_dynamic=40)
    cfg = LimoConfig()
    stamps, uvd, valid, labels = dense_tracks(
        world, cfg.capacity.max_landmarks, with_depth=True, seed=seed + 1,
        with_labels=True)
    on = lambda a: torch.as_tensor(np.asarray(a)[None], dtype=torch.float32,
                                   device=device)
    rig = CameraRig(focal=on(world.focal), principal=on(world.principal),
                    T_cam_veh=on(world.T_cam_veh))
    return stamps, uvd, valid, labels.astype(np.int32), rig, cfg, world


def fused_drive(num_frames=200, seed=11, device="cuda"):
    """The full-width fused drive, as the reference package's
    ``evaluation.evaluate_rendered_long_drive`` builds it: the configuration
    of :func:`~.pipeline.evaluation.rendered_drive_config` (``LimoConfig()``,
    20 keyframe slots × 1536 landmark slots × 1 camera, with a 1.65 m
    camera height and a 12 m/s default speed; 384 features, border 8, NMS
    radius 5; the default lidar depth; the groundplane on; clouds padded
    to 16384 points), labels on. The world is ``make_km_rendered_world(
    num_frames, seed=seed)`` (a ramp, a standstill and two turns, scaled to
    ``num_frames``) rendered at 512 × 192, f = 450, clouds drawn from
    ``np.random.default_rng(seed)``. Returns (stamps [F], images_u8
    [F,H,W], clouds (a list of [Ni,3] vehicle-frame scans), label_images
    [F,H,W] uint8, rig on ``device``, cfg, pcfg, world)."""
    world, _ = make_km_rendered_world(num_frames, seed=seed)
    pcfg = rendered_drive_config()
    cfg = pcfg.limo
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


# the drift segments of the reference package's rendered host-engine gate
KITTI_HOST_DRIFT_KW = {"lengths": (25.0, 50.0), "step": 5}


def kitti_host_drive(num_frames: int, root: str, seed: int = 9,
                     cloud_seed: int = 42):
    """The reference package's rendered host-engine gate
    (``tests/test_kitti_eval.py``, the 200-frame drift gate), cut only in
    length: ``make_world(num_frames, speed=6.0, yaw_rate=0.012,
    n_landmarks=500, n_ground=150, n_shrubbery=60, n_dynamic=40,
    dynamic_speed=6.0, seed=seed)`` rendered at 512 × 192, f = 450, with
    label images, written to ``root`` in the KITTI odometry layout (clouds
    drawn from ``np.random.default_rng(cloud_seed)``). Its configuration:
    ``LimoConfig()`` at its full 20 × 1536 × 1 with a 1.65 m camera height
    and a 6 m/s default speed; 256 features (border 8); the default lidar
    depth; the groundplane on; clouds padded to 16384 points. Returns (GT
    pose file path, LimoPipelineConfig)."""
    wi, hi, fo = 512, 192, 450.0
    world = make_world(num_frames=num_frames, speed=6.0, yaw_rate=0.012,
                       n_landmarks=500, n_ground=150, n_shrubbery=60,
                       n_dynamic=40, dynamic_speed=6.0, seed=seed,
                       focal=fo, pp=(wi / 2.0, hi / 2.0), image_size=(wi, hi))
    gt_path = write_kitti_sequence(root, world, num_frames,
                                   np.random.default_rng(cloud_seed),
                                   with_labels=True)
    pcfg = LimoPipelineConfig(
        limo=LimoConfig(
            landmark_selection=dataclasses.replace(
                LandmarkSelectionConfig(), height_over_ground=1.65),
            prior=dataclasses.replace(PriorConfig(), default_speed=6.0)),
        tracker=TrackerConfig(max_features=256, border=8),
        lidar=LidarDepthConfig(), use_groundplane=True, cloud_capacity=16384)
    return gt_path, pcfg


def entry(device="cuda"):
    """(fn, example_args): the trimmed windowed-BA solve on a KITTI-scale
    window, ``make_problem(12, 1024, 12, 600, float32)`` — the reference
    package's ``__graft_entry__.entry``."""
    w, sel, rig, cfg = make_problem(12, 1024, 12, 600, torch.float32,
                                    device=device)

    def fn(window, sel):
        return solve_trimmed(window, sel, rig, cfg)

    return fn, (w, sel)


def _mesh_shape(mesh):
    return mesh.size(0), mesh.size(1)


def _stacked(tree, n):
    return type(tree)(*[torch.stack([x] * n) for x in tree])


def dryrun_tiny(mesh):
    """Stage 1: a batch of ``data`` identical tiny windows, one per data
    group, landmarks over the model axis (``make_problem(5, max(16 model,
    32), 5, 24)``, f32). Every element finite and equal. Returns a line."""
    data, model = _mesh_shape(mesh)
    L_cap = max(16 * model, 32)
    w, sel, rig, cfg = make_problem(5, L_cap, 5, min(L_cap, 24),
                                    torch.float32, device="cpu")
    wb = shard_window(_stacked(w, data), mesh, batched=True)
    sb = shard_selection(_stacked(sel, data), mesh, batched=True)
    out_w, _, info = make_sharded_solver(mesh, rig, cfg)(wb, sb)
    full = gather_window(out_w, mesh, batched=True)
    final = info.final_cost
    if not bool(torch.isfinite(final).all() and torch.isfinite(full.poses)
                .all()):
        raise RuntimeError(f"dryrun tiny: non-finite result {final}")
    for b in range(1, data):
        if not all(torch.equal(x[0], x[b]) for x in full):
            raise RuntimeError(f"dryrun tiny: element {b} != element 0")
    return (f"dryrun_multichip ok: mesh=({data}x{model}) cost "
            f"{info.initial_cost.tolist()} -> {final.tolist()}, "
            f"{data} elements equal")


def dryrun_production(mesh):
    """Stage 2: the bench scale, ``make_problem(12, 1024, 12, 800, seed=2)``,
    landmarks over the model axis, against the unsharded solve on the same
    device. On the CPU in f64: poses within 1e-4, cost within 1e-5
    (relative), as the reference's dry run holds it. On a card in f32 (the
    kernels' type): the same rounds, trimmed mask and a cost within 1e-4,
    as chip_smoke's phase 10 holds its sharded solve. Returns a line."""
    device = mesh_device(mesh)
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    w, sel, rig, cfg = make_problem(12, 1024, 12, 800, dtype, seed=2,
                                    device="cpu")
    ref_w, ref_sel, ref_info = solve_trimmed(
        *[type(t)(*[x.to(device) for x in t]) for t in (w, sel, rig)], cfg)
    out_w, out_sel, info = make_sharded_solver(mesh, rig, cfg, batched=False)(
        shard_window(w, mesh), shard_selection(sel, mesh))
    poses = gather_window(out_w, mesh).poses
    mask = gather_selection(out_sel, mesh).lm_selected
    dp = float((poses - ref_w.poses).abs().max())
    ref = float(ref_info.final_cost)
    rel = abs(float(info.final_cost) - ref) / max(abs(ref), 1e-9)
    if dtype == torch.float64:
        ok = dp < 1e-4 and rel < 1e-5
    else:
        ok = (info.n_rounds == ref_info.n_rounds and rel < 1e-4
              and torch.equal(mask, ref_sel.lm_selected))
    if not ok:
        raise RuntimeError(f"dryrun production-shape parity: pose delta "
                           f"{dp}, cost rel delta {rel}, rounds "
                           f"{info.n_rounds} / {ref_info.n_rounds}")
    return (f"dryrun_multichip production-shape parity ok ({dtype}): max "
            f"pose delta {dp:.2e}, cost rel delta {rel:.2e}, trimmed "
            f"{int(info.n_trimmed)}")


def dryrun_fleet(mesh):
    """Stage 3: B = max(data + 1, 3) identical 24-frame scan drives (150
    landmarks, 40 ground points, 8 x 256 x 1) as a fleet over the data
    axis: each data group loads its rows (``process_local_batch``, padded
    rows replay row 0), runs them (``run_fleet`` on its device) and every
    rank gathers the global batch (``host_local_to_global``). Members are
    equal, and from frame 10 on within 1e-6 of ``run_sequence`` (f64 on
    the CPU, f32 on a card). Returns a line."""
    device = mesh_device(mesh)
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    data, _ = _mesh_shape(mesh)
    world = make_world(num_frames=24, n_landmarks=150, n_ground=40, seed=3)
    cfg = LimoConfig(capacity=CapacityConfig(
        max_keyframes=8, max_landmarks=256, max_cameras=1))
    on = lambda a: torch.as_tensor(np.asarray(a)[None], dtype=dtype,
                                   device=device)
    rig = CameraRig(focal=on(world.focal), principal=on(world.principal),
                    T_cam_veh=on(world.T_cam_veh))
    stamps, uvd, valid = dense_tracks(world, 256, with_depth=True, seed=4)
    _, one = so.run_sequence(stamps, uvd, valid, rig, cfg, dtype=dtype,
                             device=device)
    B = max(data + 1, 3)                 # forces a padded row
    start, stop, total = process_local_batch(B, mesh)
    rows = stop - start
    _, local = so.run_fleet(*[np.stack([x] * rows) for x in
                              (stamps, uvd, valid)], rig, cfg, dtype=dtype,
                            devices=[device])
    fleet = host_local_to_global(local, mesh)
    if fleet.pose.shape[0] != total:
        raise RuntimeError(f"dryrun fleet: {fleet.pose.shape[0]} rows, "
                           f"not {total}")
    d_ident = float((fleet.pose[0] - fleet.pose[B - 1]).abs().max())
    d_pose = float((fleet.pose[0, 10:] - one.pose[10:]).abs().max())
    if d_ident != 0.0 or not d_pose < 1e-6:
        raise RuntimeError(f"dryrun fleet: members differ by {d_ident}, "
                           f"steady state from run_sequence by {d_pose}")
    return (f"dryrun_multichip fleet-on-mesh ok: B={B} sequences on "
            f"data={data} (padded to {total}), {dtype} steady-state pose "
            f"delta vs single {d_pose:.2e}")


def _dryrun_rank(n, device):
    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    mesh = make_mesh(n, device_type=device)
    return [stage(mesh) for stage in
            (dryrun_tiny, dryrun_production, dryrun_fleet)]


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     backend: str = "gloo"):
    """The three stages on ``n_devices`` ranks started on this host
    (``parallel.spawn``) over a ``make_mesh(n_devices)`` mesh of
    ``device`` ranks (CUDA ranks take card ``rank % cards``: ``gloo``
    where they share a card, ``nccl`` with one card each). Every rank
    checks its stages; returns rank 0's lines."""
    lines = spawn(_dryrun_rank, n_devices, backend, args=(n_devices, device),
                  timeout_s=1800.0)[0]
    for line in lines:
        print(line, flush=True)
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m limo_tpu_torch.entry")
    ap.add_argument("mode", nargs="?", choices=["entry", "dryrun"],
                    default="entry")
    ap.add_argument("n", nargs="?", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    args = ap.parse_args(argv)
    if args.mode == "dryrun":
        dryrun_multichip(args.n, args.device, args.backend)
        return
    fn, fargs = entry(args.device)
    _, _, info = fn(*fargs)
    print(f"entry ok: cost {float(info.initial_cost):.4f} -> "
          f"{float(info.final_cost):.4f}, {info.n_iterations} LM iterations")


if __name__ == "__main__":
    from limo_tpu_torch.entry import main as _main
    _main(sys.argv[1:])
