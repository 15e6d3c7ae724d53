"""The synthetic KITTI-like world and its dense per-frame track tensors.

A frozen copy of the port's ``pipeline/synthetic.py`` (``make_world``,
``dense_tracks``): the same seed gives the same arrays, bit for bit. The
benchmark makes every scan cell's inputs here, hands them to the program
and to the reference alike, and never calls the program's own generator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from . import pose_host

# KITTI-ish camera: vehicle x-forward/z-up → camera z-forward/y-down
R_CAM_VEH = np.array([[0.0, -1.0, 0.0],
                      [0.0, 0.0, -1.0],
                      [1.0, 0.0, 0.0]])


def kitti_like_extrinsics(height: float = 1.65) -> np.ndarray:
    """pose_camera_vehicle (camera ← vehicle) with the camera ``height``
    above the vehicle origin projected to the ground."""
    m = np.eye(4)
    m[:3, :3] = R_CAM_VEH
    # camera sits at vehicle origin; ground is z = -height in vehicle frame
    return pose_host.from_matrix(m)


@dataclass
class SyntheticWorld:
    poses_veh: np.ndarray        # [F,7] vehicle←origin (world-to-body) per frame
    stamps: np.ndarray           # [F]
    landmarks: np.ndarray        # [M,3] origin frame
    is_ground: np.ndarray        # [M] bool
    focal: float
    principal: np.ndarray
    T_cam_veh: np.ndarray        # [7]
    image_size: Tuple[int, int]  # (width, height)
    labels: Optional[np.ndarray] = None      # [M] int semantic label (-2 none)
    velocities: Optional[np.ndarray] = None  # [M,3] m/s (dynamic objects)
    cam_height: float = 1.65

    def kitti_gt(self) -> np.ndarray:
        """[F,4,4] origin←frame matrices (KITTI convention)."""
        return pose_host.to_matrix(pose_host.inverse(self.poses_veh))

    def landmarks_at(self, frame_idx: int) -> np.ndarray:
        """[M,3] landmark positions at a frame (dynamic objects move)."""
        if self.velocities is None:
            return self.landmarks
        return self.landmarks + self.velocities * self.stamps[frame_idx]


def make_world(num_frames: int = 60, hz: float = 10.0, speed: float = 10.0,
               yaw_rate: float = 0.02, n_landmarks: int = 600,
               n_ground: int = 200, seed: int = 0,
               focal: float = 718.0, pp=(607.0, 185.0),
               image_size=(1241, 376), cam_height: float = 1.65,
               yaw_rate_profile: Optional[np.ndarray] = None,
               n_shrubbery: int = 0, n_dynamic: int = 0,
               dynamic_speed: float = 8.0,
               speed_profile: Optional[np.ndarray] = None
               ) -> SyntheticWorld:
    """Vehicle drives forward (+x) with a gentle yaw; landmarks populate a
    corridor along the path; ground points lie on z = -cam_height.

    ``yaw_rate_profile`` ([num_frames] rad/m) overrides the constant
    ``yaw_rate`` — S-curves for kilometre-scale drives that shouldn't close
    into a circle.

    Adversarial knobs (reference failure modes the robust machinery exists
    for): ``n_shrubbery`` vegetation points (cityscapes label 21 — the
    shrubbery-weight target; observe with extra pixel jitter via
    ``dense_tracks(..., shrubbery_px_noise=...)``); ``n_dynamic`` points on
    moving objects (label 26 'car' — in the outlier label set), grouped into
    ~10-point clusters that each share a coherent wrong motion of magnitude
    ``dynamic_speed`` m/s.

    ``speed_profile`` ([num_frames] m/s) overrides the constant ``speed`` —
    standstill stretches (speed 0: keyframe flow-rejection must fire,
    keyframe_rejection_scheme_flow.cpp:9-66) and acceleration phases for
    kilometre-scale drives."""
    rng = np.random.default_rng(seed)
    dt = 1.0 / hz
    stamps = np.arange(num_frames) * dt
    yr = (np.full(num_frames, yaw_rate) if yaw_rate_profile is None
          else np.asarray(yaw_rate_profile, np.float64))
    assert yr.shape == (num_frames,)
    sp = (np.full(num_frames, speed) if speed_profile is None
          else np.asarray(speed_profile, np.float64))
    assert sp.shape == (num_frames,)

    # integrate vehicle pose (origin←vehicle), then store inverse (veh←origin)
    # — pure numpy (pose_host): eager jnp per frame costs a device RPC each
    # on a remote TPU link, and this loop runs thousands of iterations for
    # kilometre-scale worlds
    poses = []
    heading = 0.0
    pos = np.zeros(3)
    for i in range(num_frames):
        R = np.array([[np.cos(heading), -np.sin(heading), 0],
                      [np.sin(heading), np.cos(heading), 0],
                      [0, 0, 1.0]])
        m = np.eye(4)
        m[:3, :3] = R
        m[:3, 3] = pos
        poses.append(pose_host.inverse(pose_host.from_matrix(m)))
        pos = pos + R @ np.array([sp[i] * dt, 0, 0])
        heading += yr[i] * dt * sp[i]   # yaw rate is rad/m — ×(m moved)
    poses_veh = np.stack(poses)

    # landmark corridor bent along the integrated path (so long, curving
    # trajectories keep landmarks in view): sample an arc position on the
    # path (extended ~40 m past the end), then offset laterally in the local
    # heading frame
    ref_speed = float(sp[sp > 0].mean()) if np.any(sp > 0) else speed
    ext_frames = int(40.0 / (ref_speed * dt)) + 1
    yr_ext = np.concatenate([yr, np.full(ext_frames, yr[-1])])
    sp_ext = np.concatenate([sp, np.full(ext_frames, ref_speed)])
    path_pos = np.zeros((num_frames + ext_frames, 3))
    path_head = np.zeros(num_frames + ext_frames)
    p, h = np.zeros(3), 0.0
    for i in range(num_frames + ext_frames):
        path_pos[i], path_head[i] = p, h
        R = np.array([[np.cos(h), -np.sin(h), 0],
                      [np.sin(h), np.cos(h), 0], [0, 0, 1.0]])
        p = p + R @ np.array([sp_ext[i] * dt, 0, 0])
        h += yr_ext[i] * dt * sp_ext[i]

    # cumulative arc length: structure density must be uniform PER METRE of
    # road, so sampling inverts the arc-length CDF. (Sampling uniform over
    # frame index — the r4 behavior — piles the zero-speed standstill
    # frames' share of ALL landmarks onto ONE spot: measured 162 landmarks
    # within 5 m of the km drive's parking position vs 11 at a cruise
    # position — a 15× billboard wall at the turn exit whose overlapping
    # patches' occlusion-boundary corners are not 3-D-consistent; the km
    # drive's f340-520 translation-scale collapse sat exactly in the frames
    # that see it.)
    seg_len = np.linalg.norm(np.diff(path_pos, axis=0), axis=1)
    cum_len = np.concatenate([[0.0], np.cumsum(seg_len)])

    def along_path(n, lat_lo, lat_hi, z_lo, z_hi):
        s = rng.uniform(0, cum_len[-1], n)
        i0 = np.minimum(np.searchsorted(cum_len, s, side="right") - 1,
                        len(seg_len) - 1)
        frac = (s - cum_len[i0]) / np.maximum(seg_len[i0], 1e-9)
        pos = path_pos[i0] * (1 - frac[:, None]) \
            + path_pos[i0 + 1] * frac[:, None]
        head = path_head[i0]
        lat = rng.uniform(lat_lo, lat_hi, n)
        z = rng.uniform(z_lo, z_hi, n) if z_lo != z_hi else np.full(n, z_lo)
        off = np.stack([-np.sin(head) * lat, np.cos(head) * lat, z], -1)
        return pos + off

    structure = along_path(n_landmarks, -25, 25, -1.0, 4.0)
    ground = along_path(n_ground, -8, 8, -cam_height, -cam_height)
    parts = [structure, ground]
    labels = [np.full(n_landmarks, -2, np.int32), np.full(n_ground, 7, np.int32)]
    vels = [np.zeros((n_landmarks + n_ground, 3))]
    if n_shrubbery:
        parts.append(along_path(n_shrubbery, -20, 20, -1.0, 2.0))
        labels.append(np.full(n_shrubbery, 21, np.int32))
        vels.append(np.zeros((n_shrubbery, 3)))
    if n_dynamic:
        # clusters of ~10 points sharing one coherent wrong motion each
        n_clusters = max(1, n_dynamic // 10)
        centers = along_path(n_clusters, -6, 6, -0.5, 1.5)
        cidx = rng.integers(0, n_clusters, n_dynamic)
        pts = centers[cidx] + rng.uniform(-1.5, 1.5, (n_dynamic, 3))
        ang = rng.uniform(0, 2 * np.pi, n_clusters)
        cvel = dynamic_speed * np.stack(
            [np.cos(ang), np.sin(ang), np.zeros(n_clusters)], -1)
        parts.append(pts)
        labels.append(np.full(n_dynamic, 26, np.int32))  # cityscapes 'car'
        vels.append(cvel[cidx])
    landmarks = np.concatenate(parts)
    label_arr = np.concatenate(labels)
    vel_arr = np.concatenate(vels)
    is_ground = label_arr == 7

    return SyntheticWorld(
        poses_veh=poses_veh, stamps=stamps, landmarks=landmarks,
        is_ground=is_ground, focal=focal, principal=np.asarray(pp),
        T_cam_veh=kitti_like_extrinsics(cam_height), image_size=image_size,
        labels=label_arr,
        velocities=vel_arr if np.any(vel_arr) else None,
        cam_height=cam_height)


def dense_tracks(world: SyntheticWorld, num_rows: int,
                 pixel_noise: float = 0.3, depth_noise: float = 0.03,
                 with_depth: bool = False, depth_fraction: float = 0.6,
                 max_range: float = 80.0, seed: int = 1,
                 with_labels: bool = False,
                 shrubbery_px_noise: float = 0.0,
                 depth_outlier_fraction: float = 0.0,
                 depth_dropout: Optional[Tuple[int, int]] = None):
    """Dense per-frame observation tensors for the scan-odometry evaluator
    (the scan step): landmark row = world landmark
    index (capacity-padded).

    Returns (stamps [F], uvd [F,R,3], valid [F,R]); with ``with_labels``
    additionally the per-row semantic labels [F,R] (int8; −2 = none).
    """
    out = _dense_tracks_impl(world, num_rows, None, pixel_noise, depth_noise,
                             with_depth, depth_fraction, max_range, seed,
                             shrubbery_px_noise=shrubbery_px_noise,
                             depth_outlier_fraction=depth_outlier_fraction,
                             depth_dropout=depth_dropout)
    return out[:3] + ((out[5],) if with_labels else ())


def _dense_tracks_impl(world, num_rows, reuse_gap_frames, pixel_noise,
                       depth_noise, with_depth, depth_fraction, max_range,
                       seed, min_run: int = 3, shrubbery_px_noise: float = 0.0,
                       depth_outlier_fraction: float = 0.0,
                       depth_dropout=None):
    import heapq

    rng = np.random.default_rng(seed)
    F_n = world.poses_veh.shape[0]
    M = world.landmarks.shape[0]
    W, H = world.image_size
    f, pp = world.focal, world.principal
    lm_labels = (world.labels if world.labels is not None
                 else np.full(M, -2, np.int32))

    has_depth_row = rng.uniform(size=M) < depth_fraction

    # clean projections for all frames — host-side numpy broadcasting
    # ([F,1,7] poses × [M,3] landmarks): generation must not ship an
    # [F,M,3] f64 tensor over a remote TPU link (~140 MB at km scale)
    lms = world.landmarks
    if world.velocities is not None:
        # dynamic objects: coherent cluster motion (positions per frame)
        lms = (world.landmarks[None] +
               world.velocities[None] * world.stamps[:, None, None])
    p_cam_all = pose_host.apply(
        world.T_cam_veh,
        pose_host.apply(world.poses_veh[:, None, :], lms))     # [F,M,3]
    z_all = p_cam_all[..., 2]
    ok_z = z_all > 0.5
    uv_all = np.zeros((F_n, M, 2))
    np.divide(f * p_cam_all[..., :2], z_all[..., None], out=uv_all,
              where=ok_z[..., None])
    vis = ok_z & (uv_all[..., 0] + pp[0] >= 0) & (uv_all[..., 0] + pp[0] < W) \
        & (uv_all[..., 1] + pp[1] >= 0) & (uv_all[..., 1] + pp[1] < H) \
        & (z_all < max_range)
    uv_all += pp

    # ---- row assignment ------------------------------------------------
    n_dropped = 0
    uvd = np.zeros((F_n, num_rows, 3), np.float64)
    uvd[..., 2] = -1.0
    valid = np.zeros((F_n, num_rows), bool)
    labels_arr = np.full((F_n, num_rows), -2, np.int8)
    is_shrub = lm_labels == 21

    def noisy_uv(i):
        uv = uv_all[i] + rng.normal(0, pixel_noise, (M, 2))
        if shrubbery_px_noise > 0 and np.any(is_shrub):
            # vegetation wobble: leaves move between frames, feature matches
            # on them carry extra error — what shrubbery_weight exists for
            uv[is_shrub] += rng.normal(0, shrubbery_px_noise,
                                       (int(is_shrub.sum()), 2))
        return uv

    # heavy-tailed lidar failures are per-LANDMARK systematic (the depth
    # estimator locks onto the wrong histogram segment / background for a
    # feature and stays wrong — mono_lidar_fusion failure mode), which is
    # exactly the per-group fault solveTrimmed's landmark-group rejection
    # targets; per-frame random errors would just be absorbed by Cauchy
    bad_depth_lm = rng.uniform(size=M) < depth_outlier_fraction
    depth_bias = np.where(bad_depth_lm, rng.uniform(1.4, 3.0, M), 1.0)

    def depth_col(i):
        d = z_all[i] * depth_bias + rng.normal(0, depth_noise, M)
        ok = vis[i] & has_depth_row
        if depth_dropout is not None and depth_dropout[0] <= i < depth_dropout[1]:
            ok = np.zeros(M, bool)       # lidar outage: mono-only stretch
        return np.where(ok, d, -1.0)

    if reuse_gap_frames is None:                 # identity (dense_tracks)
        assert M <= num_rows, (M, num_rows)
        row_of = np.arange(M)
        labels_arr[:, :M] = lm_labels[None, :]
        for i in range(F_n):
            uvd[i, :M, :2] = noisy_uv(i)
            if with_depth:
                uvd[i, :M, 2] = depth_col(i)
            valid[i, :M] = vis[i]
        return world.stamps.copy(), uvd, valid, n_dropped, row_of, labels_arr

    # split visibility into contiguous runs (tracker re-labels re-found
    # features as new tracks)
    padded = np.zeros((F_n + 2, M), np.int8)
    padded[1:-1] = vis
    dpad = np.diff(padded, axis=0)
    sf, sm = np.nonzero(dpad == 1)               # run start frames/landmarks
    ef, em = np.nonzero(dpad == -1)              # run end(+1) frames/landmarks
    so_ = np.lexsort((sf, sm))
    eo_ = np.lexsort((ef, em))
    m_r, first_r, last_r = sm[so_], sf[so_], ef[eo_] - 1
    assert (m_r == em[eo_]).all()
    keep = (last_r - first_r + 1) >= min_run
    m_r, first_r, last_r = m_r[keep], first_r[keep], last_r[keep]

    # greedy interval scheduling over runs
    heap: list = []                              # (frame the row frees at, row)
    next_fresh = 0
    runs = []                                    # (m, first, last, row)
    for k in np.argsort(first_r, kind="stable"):
        if heap and heap[0][0] <= first_r[k]:
            _, r = heapq.heappop(heap)
        elif next_fresh < num_rows:
            r, next_fresh = next_fresh, next_fresh + 1
        else:
            n_dropped += 1
            continue
        runs.append((m_r[k], first_r[k], last_r[k], r))
        heapq.heappush(heap, (last_r[k] + 1 + reuse_gap_frames, r))
    runs_arr = np.asarray(runs, np.int64).reshape(-1, 4)

    # per-frame landmark→row map from the scheduled runs
    row_at = np.full((F_n, M), -1, np.int32)
    for m, f0, f1, r in runs:
        row_at[f0:f1 + 1, m] = r
        labels_arr[f0:f1 + 1, r] = lm_labels[m]

    # ---- noisy measurements into row-major tensors ----------------------
    for i in range(F_n):
        uv = noisy_uv(i)
        assigned = row_at[i] >= 0
        rows = row_at[i, assigned]
        uvd[i, rows, :2] = uv[assigned]
        if with_depth:
            d = depth_col(i)
            uvd[i, rows, 2] = d[assigned]
        valid[i, rows] = vis[i, assigned]
    return world.stamps.copy(), uvd, valid, n_dropped, runs_arr, labels_arr
