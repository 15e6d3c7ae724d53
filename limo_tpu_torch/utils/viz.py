"""Visualization / publishing exporters — the offline equivalents of the
reference's ROS publishers (``publish_helpers.hpp``: landmark cloud colored
by selection/category/depth/gp, full+active paths, plane markers) and the
``pointcloud plotting`` map accumulator.

Outputs are PLY point clouds / JSON paths that any viewer (meshlab, Open3D,
rerun) can load — no ROS. A numpy copy of the reference package's
``limo_tpu/utils/viz.py``; the exporters read the host mirrors of
:class:`~limo_tpu_torch.window_manager.BundleAdjuster`.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

# category colors mirroring publishLandmarks (publish_helpers.hpp:100-188):
# near/middle/far/gp/depth get distinct colors
CAT_COLORS = {
    -1: (128, 128, 128),   # unselected — gray
    0: (0, 255, 0),        # near — green
    1: (255, 165, 0),      # middle — orange
    2: (255, 0, 0),        # far — red
}
GP_COLOR = (0, 128, 255)
DEPTH_COLOR = (255, 255, 0)


def color_by_index_hsv(ids, num_colors: int = 16) -> np.ndarray:
    """Deterministic per-id RGB colors — the reference's
    ``get_color(ID, NumColors)`` (color_by_index_hsv.hpp:29-42): id 0 maps to
    a fixed color, other ids to evenly spaced hues (OpenCV HSV: H ∈ [0,180),
    S = V = 200) modulo ``num_colors``. Vectorized over an id array."""
    ids = np.asarray(ids, np.int64)
    mod = (ids - 1) % num_colors
    h = mod * (180 // num_colors)          # OpenCV hue: degrees/2
    s, v = 200 / 255.0, 200 / 255.0
    # HSV→RGB (matplotlib-free): OpenCV hue*2 = degrees
    hh = (h * 2.0) / 60.0
    i = np.floor(hh).astype(np.int64) % 6
    f = hh - np.floor(hh)
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    vv = np.full_like(f, v)
    pp = np.full_like(f, p)
    r = np.choose(i, [vv, q, pp, pp, t, vv])
    g = np.choose(i, [t, vv, vv, q, pp, pp])
    b = np.choose(i, [pp, pp, t, vv, vv, q])
    rgb = np.stack([r, g, b], -1)
    out = np.clip(np.round(rgb * 255), 0, 255).astype(np.int32)
    # id 0 sentinel: reference BGR(123,22,234) → RGB
    out[ids == 0] = (234, 22, 123)
    return out


def flow_image(ba, shape=(600, 1300), num_colors: int = 10) -> np.ndarray:
    """Debug image of the window's measurements — the reference's
    ``getFlowImg`` (general_helpers.hpp:148-168): for every active keyframe,
    a dot at each landmark's (u,v) in its first camera, colored
    deterministically by landmark id. Returns an [H,W,3] uint8 RGB image."""
    h, w = shape
    img = np.zeros((h, w, 3), np.uint8)
    for s in ba._kf_order:
        m = ba._obs_mask[:, s, 0]
        slots = np.flatnonzero(m & (ba._lm_id >= 0))
        if slots.size == 0:
            continue
        uv = np.round(ba._obs[slots, s, 0, :2]).astype(np.int64)
        cols = color_by_index_hsv(ba._lm_id[slots], num_colors).astype(np.uint8)
        # radius-1 filled circle ≈ plus-shaped 5-pixel stamp
        for du, dv in ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)):
            u = uv[:, 0] + du
            v = uv[:, 1] + dv
            ok = (u >= 0) & (u < w) & (v >= 0) & (v < h)
            img[v[ok], u[ok]] = cols[ok]
    return img


def write_ply(path: str, points: np.ndarray,
              colors: Optional[np.ndarray] = None) -> None:
    n = points.shape[0]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i, 0]:.4f} {points[i, 1]:.4f} {points[i, 2]:.4f}"
            if colors is not None:
                row += f" {int(colors[i, 0])} {int(colors[i, 1])} {int(colors[i, 2])}"
            f.write(row + "\n")


def export_landmarks(ba, path: str, categories: Optional[np.ndarray] = None
                     ) -> int:
    """Landmark cloud colored by category / gp / depth
    (publishLandmarks equivalent). Returns point count."""
    known = ba._lm_valid & ba._lm_known
    idx = np.flatnonzero(known)
    pts = ba._lm_pos[idx]
    cols = np.zeros((idx.size, 3), np.int32)
    for r, i in enumerate(idx):
        if ba._lm_is_gp[i]:
            cols[r] = GP_COLOR
        elif ba._lm_has_depth[i]:
            cols[r] = DEPTH_COLOR
        elif categories is not None:
            cols[r] = CAT_COLORS.get(int(categories[i]), CAT_COLORS[-1])
        else:
            cols[r] = CAT_COLORS[-1]
    write_ply(path, pts, cols)
    return idx.size


def export_paths(ba, path: str) -> None:
    """Full + active trajectory (publishPaths equivalent: poses inverted to
    origin ← keyframe)."""
    from ..geometry import pose_host

    def inv(p):
        return pose_host.inverse(np.asarray(p, np.float64))

    full = [{"stamp": float(st), "position": inv(p)[4:].tolist()}
            for st, p in sorted(ba._archive.items())]
    active = [{"stamp": float(ba._stamps[s]), "position": inv(ba._poses[s])[4:].tolist()}
              for s in ba._kf_order]
    with open(path, "w") as f:
        json.dump({"full": full + active, "active": active}, f)


def export_planes(ba, path: str) -> None:
    """Per-keyframe local groundplane markers (publishPlanes equivalent)."""
    planes = [{"stamp": float(ba._stamps[s]),
               "normal": ba._planes[s][:3].tolist(),
               "distance": float(ba._planes[s][3])}
              for s in ba._kf_order if ba._plane_valid[s]]
    with open(path, "w") as f:
        json.dump(planes, f)


def accumulate_map(poses_kitti: np.ndarray, clouds, T_cam_sensor: np.ndarray,
                   out_ply: str, voxel: float = 0.5, max_pts: int = 2_000_000
                   ) -> int:
    """Accumulate sensor clouds along an estimated trajectory into one global
    map — the ``pointcloud plotting/accumulate_lidar_pcl_from_trajectory_
    estimate.py`` equivalent (each scan transformed by pose · T_cam_sensor).

    clouds: iterable of [N,3] arrays aligned with poses. Voxel-dedups
    (first point per voxel wins, in scan order), capped at ``max_pts``."""
    all_pts = []
    all_keys = []
    for pose, cloud in zip(poses_kitti, clouds):
        T = pose @ T_cam_sensor
        p = cloud[:, :3] @ T[:3, :3].T + T[:3, 3]
        cell = np.floor(p / voxel).astype(np.int64)
        # pack 3 cell coords into one int64 key (21 bits each, signed)
        k = ((cell[:, 0] & 0x1FFFFF) << 42) | ((cell[:, 1] & 0x1FFFFF) << 21) \
            | (cell[:, 2] & 0x1FFFFF)
        all_pts.append(p)
        all_keys.append(k)
    if not all_pts:
        write_ply(out_ply, np.zeros((0, 3)))
        return 0
    pts = np.concatenate(all_pts)
    keys = np.concatenate(all_keys)
    _, first = np.unique(keys, return_index=True)
    first.sort()  # keep first-come (scan) order
    arr = pts[first[:max_pts]]
    write_ply(out_ply, arr)
    return arr.shape[0]
